from repro_torch.data.synthetic import (  # noqa: F401
    augment, batches, dirichlet_shards, macenko_normalize, make_histo_dataset,
    paper_splits, shard_to_nodes,
)
