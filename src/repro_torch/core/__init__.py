"""Core of the port: primal SVM objective, gossip topologies, Push-Sum and
the GADGET trainer, as PyTorch functions on tensors."""
