from repro_torch.data.synthetic import (  # noqa: F401
    augment, batches, dirichlet_shards, macenko_normalize, make_histo_dataset,
    make_lm_stream, paper_splits, shard_to_nodes,
)
