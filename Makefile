# Test tiers ---------------------------------------------------------------
# fast tier (default; pytest.ini deselects @slow): all reference-golden,
# oracle and parity coverage. full tier adds DMFT loops. test-gpu runs the
# tests marked gpu on the machine's GPU.
test:
	python -m pytest tests/ -q

# the slow tier runs ONE pytest process PER FILE: this jaxlib build
# segfaults when hundreds of live compiled executables accumulate in a
# single process (each slow file passes in isolation)
test-full: test
	for f in $$(grep -rl "pytest.mark.slow" tests/*.py); do \
	  echo "== $$f"; python -m pytest $$f -q -m slow || exit 1; \
	done

test-gpu:
	EDIPACK_TPU_GPU_TESTS=1 python -m pytest tests/ -q -m gpu

bench:
	python bench.py

# end-to-end run on one GPU (--four: the sharded sector on four GPUs)
smoke:
	python chip_smoke.py

# C API shared library (capi/Makefile builds libedipack_tpu_c.so + the
# reference-ABI compat layer)
capi:
	$(MAKE) -C edipack_tpu/capi

# runnable examples (Bethe DMFT loop; Python + reference-ABI C driver)
examples: capi
	cd examples/python && PYTHONPATH=../.. python hm_bethe.py nloop=3
	$(MAKE) -C examples/c
	cd examples/c && PYTHONPATH=../.. ./hm_bethe

.PHONY: test test-full test-gpu bench smoke capi examples
