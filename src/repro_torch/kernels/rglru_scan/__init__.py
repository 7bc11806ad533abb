"""The RG-LRU linear recurrence for Hopper: the ``rglru_scan`` kernel and its
plain version in ``rglru_scan.py``, its CUDA source under ``csrc/``, the
entry point and cost model in ``ops.py`` and the oracle in ``ref.py``."""
