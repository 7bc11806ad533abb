"""Dense hinge-subgradient kernels for Hopper: ``fleet_half_step``,
``margins`` and ``grad_update`` (training) in ``hinge_subgrad.py``,
``dense_scores`` (serving) in ``predict.py``, their CUDA sources under
``csrc/``, plain PyTorch oracles in ``ref.py`` and the dispatch layer in
``ops.py``."""
