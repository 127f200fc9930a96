# Convenience targets (the reference's CMake equivalent, CMakeLists.txt:1-25;
# the Python package needs no build — only the native host library does).

PY ?= python

.PHONY: test test-fast gpu-tests chip-smoke bench demo native clean

test:  ## full CPU test suite on the 8-device virtual mesh (merge gate)
	$(PY) -m pytest tests/ -q

test-fast:  ## inner-loop tier: skips the statistically heavy `slow` tests
	$(PY) -m pytest tests/ -q -m "not slow"

gpu-tests:  ## GPU tier: compiled Triton kernels vs the XLA engine (needs a GPU)
	$(PY) -m pytest tests_gpu/ -q

chip-smoke:  ## main path at the reference sizes on one GPU (last line: JSON)
	$(PY) chip_smoke.py

bench:  ## benchmark harness (one JSON line)
	$(PY) bench.py

demo:  ## hello.cu-equivalent demo table
	$(PY) -m mc_tpu demo

native:  ## (re)build the C++ host library
	$(PY) -c "from mc_tpu.native import lib; print('ok' if lib.build(force=True) else 'FAILED')"

clean:
	rm -f mc_tpu/native/_mc_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
