"""The RWKV-6 WKV recurrence for Hopper: the ``wkv_scan`` kernel and its
plain version in ``rwkv6_scan.py``, its CUDA source under ``csrc/``, the
entry point and cost model in ``ops.py`` and the oracle in ``ref.py``."""
