"""Flat parameter layout: one contiguous f32 buffer per node axis.

The reference keeps params, AdamW moments and importance statistics as
stacked pytrees (71 leaves for the paper CNN), and its commit launches one
kernel per leaf. The port holds each of them as a single ``[N, P]`` tensor
instead; a :class:`FlatLayout` (leaf path → offset, shape) hands out per-leaf
views into it, so a commit is one kernel launch over ``[N, P]``.

Leaf paths are dotted (``"blocks.0.layers.1.bn.scale"``), the same names
``nn.Module.named_parameters`` gives, and map one to one onto the reference's
tree paths (``["blocks"][0]["layers"][1]["bn"]["scale"]``). A flat payload
dict's ``/``-joined paths (``"head/proj/lora_A"``) are single keys.

**Wide leaves** (a bf16 LM's ``A_log``, ``D``, ``dt_bias`` and adapter
``lora_scale``, which the reference keeps in f32) sit first in a 16-bit
buffer, as f32 values over two slots each: the buffer's **slots** are its
storage, its **values** the numbers the leaves hold, ``n_wide`` f32 values
and ``n_rest`` 16-bit ones. :meth:`FlatLayout.parts` splits a slot buffer
into its f32 prefix (a view) and its 16-bit rest, :meth:`FlatLayout.join`
puts them back, so a loss over :meth:`FlatLayout.unflatten_parts` of the two
parts gives each part its gradient, and the optimizer updates the prefix
as f32 numbers. Whatever treats the params as numbers (moments, importance
statistics, the wire, merges, checksums) works on the ``[..., n_values]``
f32 **value** vector (:meth:`FlatLayout.values`, whose leaves sit in the
order of :attr:`FlatLayout.value_layout`); :meth:`FlatLayout.from_values`
writes values back into slots, each leaf in its own dtype. Without wide
leaves slots and values coincide.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    path: str
    shape: Tuple[int, ...]
    offset: int
    wide: bool = False   # f32 values in two slots of a 16-bit buffer
    conv: bool = False   # a conv weight, stored OIHW (HWIO in the reference)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def slots(self) -> int:
        return 2 * self.size if self.wide else self.size

    @property
    def ref_axes(self) -> Tuple[int, ...]:
        """The stored leaf's axes in the reference's order: the stored
        leaf transposed by them is the reference's (OIHW → HWIO for a
        conv, no change otherwise)."""
        return (2, 3, 1, 0) if self.conv else tuple(range(len(self.shape)))


class _DtypeView(torch.autograd.Function):
    """``x.view(dtype)`` (a dtype of another width reinterprets the last
    dim) with a ``torch.func.vmap`` rule: not every PyTorch release has a
    batching rule for ``aten::view.dtype``, and the engine vmaps the train
    step and the gate over the node axis. It carries no gradient."""

    @staticmethod
    def forward(x, dtype):
        return x.view(dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, dtype):
        return _DtypeView.apply(x.movedim(in_dims[0], 0), dtype), 0


def view_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype) if x.dtype == dtype else _DtypeView.apply(x, dtype)


class FlatLayout:
    """Fixed leaf order over a flat parameter vector of length ``size``
    (slots; ``wide`` names the leaves held as f32 in a 16-bit buffer,
    ``convs`` the conv weights, stored OIHW where the reference keeps
    HWIO; any other leaf is stored as the reference keeps it)."""

    def __init__(self, leaves: Sequence[Tuple[str, Sequence[int]]],
                 wide: Iterable[str] = (), convs: Iterable[str] = ()):
        wide, convs = frozenset(wide), frozenset(convs)
        leaves = [Leaf(path, tuple(int(s) for s in shape), 0, path in wide,
                       path in convs)
                  for path, shape in leaves]
        if wide - {leaf.path for leaf in leaves}:
            raise ValueError(f"wide leaves {sorted(wide)} not in the layout")
        if convs - {leaf.path for leaf in leaves if len(leaf.shape) == 4}:
            raise ValueError(f"conv leaves {sorted(convs)} are not 4-D "
                             f"leaves of the layout")
        self.convs = convs
        # buffer order: the wide leaves first (even offsets), then the rest
        self._order = sorted(range(len(leaves)), key=lambda i: not
                             leaves[i].wide)
        off = 0
        for i in self._order:
            leaves[i] = dataclasses.replace(leaves[i], offset=off)
            off += leaves[i].slots
        self.leaves: Tuple[Leaf, ...] = tuple(leaves)
        self.wide = wide
        self._sizes = [leaves[i].slots for i in self._order]
        self.n_wide = sum(leaf.size for leaf in leaves if leaf.wide)
        self.n_rest = sum(leaf.size for leaf in leaves if not leaf.wide)
        self.n_values = self.n_wide + self.n_rest
        self.pad = 0
        if wide and off % 2:
            self._sizes.append(1)
            self.pad = 1
            off += 1
        self.size = off
        self._value_layout = None

    @property
    def value_layout(self) -> "FlatLayout":
        """The layout of the value vector: the same leaves in storage order,
        one f32 value each (this layout itself when no leaf is wide)."""
        if not self.wide:
            return self
        if self._value_layout is None:
            self._value_layout = FlatLayout(
                [(self.leaves[i].path, self.leaves[i].shape)
                 for i in self._order], convs=self.convs)
        return self._value_layout

    def parts(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """A slot buffer ``[..., P]`` → ``(flat,)``, or with wide leaves
        ``(prefix [..., n_wide] f32, rest [..., n_rest])`` (views; the pad
        slot left out)."""
        if not self.wide:
            return (flat,)
        w = 2 * self.n_wide
        return (view_dtype(flat[..., :w], torch.float32),
                flat[..., w:w + self.n_rest])

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Inverse of :meth:`parts`: a new slot buffer in the rest's
        dtype."""
        if not self.wide:
            return parts[0]
        wide, rest = parts
        pieces = [view_dtype(wide.to(torch.float32).contiguous(), rest.dtype),
                  rest]
        if self.pad:
            pieces.append(rest.new_zeros(rest.shape[:-1] + (1,)))
        return torch.cat(pieces, dim=-1)

    def values(self, flat: torch.Tensor) -> torch.Tensor:
        """A slot buffer → its f32 value vector ``[..., n_values]`` (the
        buffer itself when it is f32 without wide leaves). Each part is
        cast straight into the one new tensor."""
        if not self.wide:
            return flat.to(torch.float32)
        out = flat.new_empty(flat.shape[:-1] + (self.n_values,),
                             dtype=torch.float32)
        wide, rest = self.parts(flat)
        out[..., :self.n_wide].copy_(wide)
        out[..., self.n_wide:].copy_(rest)
        return out

    def from_values(self, values: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
        """Inverse of :meth:`values`: wide leaves as f32 bits, the others
        cast to ``dtype``, straight into the one new slot buffer."""
        if not self.wide:
            return values.to(dtype)
        out = values.new_empty(values.shape[:-1] + (self.size,), dtype=dtype)
        w = 2 * self.n_wide
        out[..., :w].view(torch.float32).copy_(values[..., :self.n_wide])
        out[..., w:w + self.n_rest].copy_(values[..., self.n_wide:])
        if self.pad:
            out[..., -1] = 0
        return out

    @classmethod
    def of_module(cls, module: torch.nn.Module) -> "FlatLayout":
        """The layout of a module's params; its 4-D params are conv
        weights (OIHW, PyTorch's layout)."""
        named = list(module.named_parameters())
        return cls([(name, p.shape) for name, p in named],
                   convs=[name for name, p in named if p.dim() == 4])

    @classmethod
    def of_payload(cls, payload: Dict[str, torch.Tensor]) -> "FlatLayout":
        """The layout of a flat payload dict (``{"head/out/b": ...}``, the
        heterogeneous swarm's wire payload): its paths sorted, the
        reference's leaf order."""
        return cls([(k, tuple(payload[k].shape)) for k in sorted(payload)])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[..., P]`` → {path: ``[..., *shape]`` view}. One ``split``, so the
        gradient of a loss over the views comes back as one flat ``[..., P]``
        tensor (the split's backward is a single concatenation). With wide
        leaves a 16-bit buffer is read as slots (the f32 views carry no
        gradient: differentiate :meth:`unflatten_parts` instead) and an f32
        ``[..., n_values]`` buffer as values."""
        if not self.wide:
            parts = flat.split(self._sizes, dim=-1)
            return {self.leaves[i].path: part.reshape(
                flat.shape[:-1] + self.leaves[i].shape)
                for i, part in zip(self._order, parts)}
        if flat.element_size() == 4 and flat.shape[-1] == self.n_values:
            return self.value_layout.unflatten(flat)
        if flat.element_size() != 2:
            raise ValueError(f"a layout with wide leaves reads a 16-bit "
                             f"slot buffer or an f32 value vector, got "
                             f"{flat.dtype} [..., {flat.shape[-1]}]")
        return self.unflatten_parts(self.parts(flat))

    def unflatten_parts(self, parts: Sequence[torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """:meth:`parts` (``(wide, rest)``, or ``(flat,)``) → {path:
        view}; a loss over the views gives each part its gradient."""
        if not self.wide:
            return self.unflatten(parts[0])
        wide, rest = parts
        lead = rest.shape[:-1]
        views = {}
        for kind, part in ((True, wide), (False, rest)):
            order = [i for i in self._order if self.leaves[i].wide == kind]
            pieces = part.split([self.leaves[i].size for i in order], dim=-1)
            for i, piece in zip(order, pieces):
                leaf = self.leaves[i]
                views[leaf.path] = piece.reshape(lead + leaf.shape)
        return {leaf.path: views[leaf.path] for leaf in self.leaves}

    def flatten(self, params: Dict[str, torch.Tensor],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """{path: tensor ``[*lead, *shape]``} → contiguous ``[*lead, P]``,
        in ``dtype`` when given (wide leaves as f32 bits)."""
        if self.wide and (dtype is None or dtype.itemsize != 2):
            raise ValueError("a layout with wide leaves flattens into a "
                             "16-bit dtype")
        parts = []
        for i in self._order:
            leaf = self.leaves[i]
            t = params[leaf.path]
            t = t.reshape(t.shape[:t.dim() - len(leaf.shape)] + (-1,))
            if leaf.wide:
                t = t.to(torch.float32).contiguous().view(dtype)
            elif dtype is not None:
                t = t.to(dtype)
            parts.append(t)
        if len(self._sizes) > len(parts):      # the pad slot
            parts.append(parts[-1].new_zeros(parts[-1].shape[:-1] + (1,)))
        return torch.cat(parts, dim=-1)
