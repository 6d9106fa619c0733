"""Path-axis sharding over ``torch.distributed`` ranks (mesh.py, distributed.py,
collectives.py)."""
