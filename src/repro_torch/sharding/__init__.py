"""Sharding rules (``partition``) and the expert-parallel MoE (``ep``) over
``torch.distributed``."""
