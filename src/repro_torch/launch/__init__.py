"""Launch layer of the transformer scaffolding: the prefill and serve step
factories (``steps``) and the token-decode entry point (``serve``). These decode
tokens, not SVM scores; SVM serving lives in ``repro_torch.serve``."""
