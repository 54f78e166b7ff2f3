"""Sharding rules (``partition``), tensor-parallel compute over ``model``
(``tp``) and the expert-parallel MoE (``ep``) over ``torch.distributed``."""
