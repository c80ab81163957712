"""Tensor parallelism of the paged serving path over ``torch.distributed``
(port of ``repro/distributed``): logical-axis rules (``sharding``), the
per-rank ``PagedTP`` (``tp``) and deployment-time transforms
(``transforms``)."""
