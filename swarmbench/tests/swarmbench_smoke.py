"""Small stand-ins of the benchmark's cells for the CPU tests: each cell's
own files with the widths, depth and traffic cut to seconds on the CPU."""
import copy

from swarmbench import harness

CELLS = ("histo-densenet224-n4.local", "mamba2-370m-n4.local")


def small(cell: str):
    """(workload, config) of ``cell`` at a small size."""
    wl = copy.deepcopy(harness.load_json("workloads", cell))
    cfg = copy.deepcopy(harness.load_json("configs", wl["config"]))
    if cfg["driver"] == "histo":
        cfg["model"].update(image_size=32, growth=4, stem=8, feat_dim=32,
                            hidden=16, n_blocks=2, layers_per_block=2)
        wl["traffic"].update(batch_per_node=8, val_per_node=16, pool=100)
        wl["swarm"]["sync_every"] = 4
    else:
        cfg["model"].update(n_layers=2, d_model=64, ssm_state=16,
                            ssm_head_dim=16, ssm_chunk=16, vocab_size=512)
        wl["traffic"].update(batch_per_node=2, seq_len=32, pool_seqs=8)
        wl["swarm"]["sync_every"] = 3
    return wl, cfg


def control_policy(cfg: dict) -> str:
    return "bf16" if cfg["model"].get("param_dtype",
                                      "float32") == "float32" else "fp8"
