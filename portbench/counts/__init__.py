"""The benchmark's own counts: the card's peaks, a step's FLOPs counted on
the plain reference model, and the preprocess kernel's byte bound."""
