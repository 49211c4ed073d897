"""The work a kernel or a model step needs, from shapes (the yardstick;
frozen). Operations are counted as multiply-adds × 2; bytes as each input
read once and each output written once."""
from __future__ import annotations


def commit_bytes(n: int, p: int, itemsize: int = 4, imp: bool = False) -> int:
    """The fused commit ``θ_i ← gate_i ? Σ_j W_ij θ_j : θ_i`` of N rows of
    P values: x [N, P] in, W [N, N] f32 and the gates [N] in (the
    importance [N, P] f32 too when given), the rows [N, P] out."""
    return (2 * n * p * itemsize + n * n * 4 + n
            + (n * p * 4 if imp else 0))


def ssd_bound(b, s, h, p, n, chunk, g, bw, peak, bf16_peak, itemsize=2):
    """(bound seconds, bound by, operations, bytes) of one SSD forward call
    in the 16-bit form: x, dt, a_log, B, C in, y and the f32 state out; per
    chunk C·Bᵀ over the causal pairs (2N each) once per group at the
    bf16 rate, and per head the pairs' weighted x (2P each) and the carried
    state's 2·L·N·P twice at the f32 rate; the operation time is the sum
    of the two."""
    nbytes = ((2 * b * s * h * p + 2 * b * s * g * n) * itemsize
              + b * s * h * 4 + h * 4 + b * h * p * n * 4)
    pairs, chunks = chunk * (chunk + 1) // 2, s // chunk
    f32_ops = b * h * chunks * (pairs * 2 * p + 4 * chunk * n * p)
    bf16_ops = b * g * chunks * pairs * 2 * n
    bytes_s = nbytes / bw
    ops_s = f32_ops / peak + bf16_ops / bf16_peak
    return (max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s
            else "operations", f32_ops + bf16_ops, nbytes)


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def cnn_forward_flops(m: dict) -> dict:
    """Forward operations of one image through the DenseNet-lite: every
    convolution and FC product (BN, activations and pooling left out).
    Returns {"total", "stem"}; the stem's input gradient is never formed,
    so a training step costs ``3·total − stem``."""
    s = m["image_size"]
    h = _same_out(s, 2)
    stem = 2 * h * h * m["stem"] * 3 * 49
    h = _same_out(h, 2)                      # 3×3/2 max pool
    total, c = stem, m["stem"]
    for b in range(m["n_blocks"]):
        for _ in range(m["layers_per_block"]):
            total += 2 * h * h * m["growth"] * c * 9
            c += m["growth"]
        t = c // 2 if b < m["n_blocks"] - 1 else m["feat_dim"]
        total += 2 * h * h * t * c
        c = t
        if h >= 2:
            h //= 2
    total += 2 * m["feat_dim"] * m["hidden"] + 2 * m["hidden"] * m["n_classes"]
    return {"total": total, "stem": stem}
