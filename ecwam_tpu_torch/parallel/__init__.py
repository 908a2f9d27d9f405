"""Multi-device decompositions and sharded models over torch.distributed."""
