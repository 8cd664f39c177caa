"""Tensor-parallel serving: the sharding rules (``sharding``) and the
rank-local pool over ``torch.distributed`` (``tp_pool``)."""
