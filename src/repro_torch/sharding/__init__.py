"""Inner (within-node) sharding of a node's params over the ``data`` and
``model`` axes of the swarm mesh (:mod:`repro_torch.sharding.rules`)."""
