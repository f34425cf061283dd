"""Sharded island evolution over the ranks of a mesh (``torch.distributed``)."""
