# Ops targets (SURVEY §2.1 "Ops scripts" — the reference's Makefile surface,
# minus the university grid-engine scripts which don't apply to TPU hosts).

PY ?= python
DATA_DIR ?= data
CKPT_DIR ?= checkpoints
CONFIG ?= make3d-encdec
STEPS ?= 5000

.PHONY: test test-fast download-make3d download-nyu train eval live bench \
        bench-serving native clean perf-check synth-data rehearsal prepare

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -m "not slow"

download-make3d:
	$(PY) -m ann3depth_tpu download --dataset make3d --data-dir $(DATA_DIR)

download-nyu:
	$(PY) -m ann3depth_tpu download --dataset nyu --data-dir $(DATA_DIR)

train:
	$(PY) -m ann3depth_tpu train --config $(CONFIG) --steps $(STEPS) \
	    --data-dir $(DATA_DIR) --ckpt-dir $(CKPT_DIR)

eval:
	$(PY) -m ann3depth_tpu eval --config $(CONFIG) --data-dir $(DATA_DIR) \
	    --ckpt-dir $(CKPT_DIR)

live:
	$(PY) -m ann3depth_tpu live --config live --ckpt-dir $(CKPT_DIR)

bench:
	$(PY) bench.py

bench-serving:
	$(PY) -m ann3depth_tpu bench --serving --config $(CONFIG)

# The PyTorch port on the card (add DEVICE=cpu to run on the CPU).
DEVICE ?= cuda

.PHONY: torch-train torch-bench torch-bench-serving

torch-train:
	$(PY) -m ann3depth_tpu_torch train --config $(CONFIG) --steps $(STEPS) \
	    --data-dir $(DATA_DIR) --ckpt-dir $(CKPT_DIR) --device $(DEVICE)

torch-bench:
	$(PY) -m ann3depth_tpu_torch bench --config $(CONFIG) --device $(DEVICE)

torch-bench-serving:
	$(PY) -m ann3depth_tpu_torch bench --serving --config $(CONFIG) \
	    --device $(DEVICE)

# build the native ring buffer ahead of time (also built lazily on import)
native:
	mkdir -p native/build
	g++ -O2 -shared -fPIC -std=c++17 -o native/build/libringbuffer.so \
	    native/ringbuffer.cpp

clean:
	rm -rf native/build benchmarks/results.jsonl

perf-check:
	$(PY) -m benchmarks.check_regression

# True-scale synthetic stand-ins (authentic dimensions/formats) for offline
# end-to-end rehearsal of the real-data chain (tools/synth_real_scale.py).
synth-data:
	$(PY) tools/synth_real_scale.py $(DATA_DIR)

prepare:
	$(PY) -m ann3depth_tpu prepare --dataset make3d --data-dir $(DATA_DIR) --split train
	$(PY) -m ann3depth_tpu prepare --dataset make3d --data-dir $(DATA_DIR) --split test
	$(PY) -m ann3depth_tpu prepare --dataset nyu --data-dir $(DATA_DIR) --split train
	$(PY) -m ann3depth_tpu prepare --dataset nyu --data-dir $(DATA_DIR) --split test

# Full offline dress rehearsal: synth -> verify/extract -> pack records.
# Sequential sub-makes, NOT prerequisites: download needs synth's archives
# already staged, so `make -j` must not run them concurrently.
rehearsal:
	$(MAKE) synth-data
	$(MAKE) download-make3d
	$(MAKE) download-nyu
	$(MAKE) prepare
