"""Quantized collectives and int8 serving weights — port of
`proteinbert_tpu/parallel/quant.py` (EQuARX, arXiv:2506.17615).

**Training — the quantized reduce-scatter** (JAX :107-289). The
data-parallel front half (`train_state.corrupt_replica_grads`) gives each
rank its PARTIAL gradients: the gradient of its share of the global loss
(local numerators over denominators summed across the data group). Each
sharded leaf's partial is cut into one slice per destination along its
ZeRO dim (`sharding.zero_dim`, the rule that lays out the persistent
moments), the slices are quantized —

  bf16: random 16 bits added to the fp32 pattern, then truncated
        (`stochastic_round_bf16`, unbiased);
  int8: near-equal chunks of at most QUANT_CHUNK elements, a scale of
        amax/127 each, floor(y + u) (`quantize_int8_chunks`);
  fp32: unrounded (the measurement control) —

and go out in ONE `all_to_all_single` (plus one for the int8 scales).
Each rank dequantizes and sums the d slices it receives into its shard,
then the ZeRO-1 update and all-gather of `parallel/zero.py` follow. The
whole leaves and the clip norm's sum of squares ride one fp32
all-reduce. On a data × fsdp mesh (`make_quant_fsdp_train_step`) the
forward and backward read the params gathered from their fsdp shards,
the slices go to the ZeRO pieces of `parallel/fsdp.MeshLayout` (each
inside its rank's fsdp shard, `FsdpQuantLayout`), and the updated
pieces are gathered back into the shards. bf16 payloads go on the wire
as bf16 (JAX bitcasts to uint16 only because CPU XLA widens bf16
collectives; NCCL and gloo move bf16, and gloo refuses int16). The noise comes from a
generator seeded from the step's generator and the replica index
(`train_state.replica_generators`): deterministic, the same under resume.
`check_quant_mesh` raises `QuantConfigError` with the JAX messages.

**Serving — the int8 arm** (JAX :95, :476-564, :599-773). The int8 arm
quantizes a trunk ONCE at load (`quantize_params`: symmetric, one float32
scale per output channel, round to nearest even) and serves it through
the quantized entries below. Each entry takes the quantized tree and runs
the fp32 arm's own entry body (`inference.py`) on
`partial_dequantize_params(qparams)`: the block weights the kernels take
natively stay int8 (`_INKERNEL_QUANT_KEYS`) and go to the int8 legs of
#3, K2 and #6, which dequantize on the card; every other weight is
dequantized per call. So the quantized arm cannot drift from the fp32
arm's semantics.

Task heads: `_q_trunk_batch` / `_q_packed_trunk_batch` are the shared
trunk of `predict_task` on the int8 arm (the trunk through the int8 legs
of K2 and #3, or K1 on dequantized track weights); the head tails that
read the trunk's output stay float32.

`quantize_rows_int8` / `dequantize_rows_int8` are copies of the JAX
host-numpy row quantizers (`parallel/quant.py:567-600`) that the
neighbour index builder (`index/store.py`) quantizes its residual vectors
with.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.configs import ModelConfig
from proteinbert_tpu_torch.data.vocab import PAD_ID
from proteinbert_tpu_torch.heads import apply as heads_apply
from proteinbert_tpu_torch.kernels.quant_leaves import (
    dequant_leaf, dequant_params, is_quant_leaf,
)
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.ops.layers import dense_apply

# Serving quantization modes (configs.ServeConfig.quant): fp32 = the
# ordinary entries; int8 = int8 weights; int8_act = int8 weights + dynamic
# int8 fake-quant of the trunk's output activations (bucketed only).
SERVE_QUANT_MODES = ("fp32", "int8", "int8_act")


def _quant(w: torch.Tensor):
    """One leaf → {"q": int8, "scale": float32}, the scale reduced over
    axis -2 — `quantize_params`' formula, operation for operation."""
    w = w.float()
    amax = w.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _quantize_blocks(blocks: List[Any]) -> List[Any]:
    """The blocks as the JAX package quantizes its stacked (num_blocks,
    ...) block tensors: a leaf of two or more dims per block gets its own
    per-channel scales; a block's VECTOR (bias, LN scale) is a (blocks,
    C) stack there, so it is quantized too, with each channel's scale
    taken over all the blocks and shared by them."""

    def walk(leaves: List[Any]):
        if isinstance(leaves[0], dict):
            return [dict(zip(leaves[0], vals)) for vals in zip(*(
                walk([leaf[k] for leaf in leaves]) for k in leaves[0]))]
        if not leaves[0].is_floating_point():
            return leaves
        if leaves[0].dim() >= 2:
            return [_quant(leaf) for leaf in leaves]
        stacked = _quant(torch.stack(leaves))
        return [{"q": stacked["q"][i], "scale": stacked["scale"]}
                for i in range(len(leaves))]

    return walk(list(blocks))


def quantize_params(params: Any) -> Any:
    """Symmetric per-output-channel int8 quantization of a trunk at load
    time, bit for bit the JAX `quantize_params` on the same weights: every
    float leaf with two or more dims (dense/conv kernels, embeddings,
    attention projections) becomes {"q": int8, "scale": float32}, scale =
    amax over the input axis (-2) / 127 (1.0 where the amax is 0), q =
    round(w / scale) clipped to ±127; in the blocks, whose leaves the JAX
    package stacks, the vectors too (`_quantize_blocks`). Other 1-D leaves
    stay float32."""
    if isinstance(params, dict) and "blocks" in params:
        out = {k: quantize_params(v) for k, v in params.items()
               if k != "blocks"}
        out["blocks"] = _quantize_blocks(params["blocks"])
        return out

    def leaf(t):
        return _quant(t) if t.dim() >= 2 and t.is_floating_point() else t

    return _tree_map(leaf, params)


def dequantize_params(qparams: Any) -> Any:
    """Quantized tree → float32 params (q·scale)."""
    return dequant_params(qparams)


# The block weights the kernels take natively: the int8 legs of #3, K2
# and #6 dequantize them on the card. Everything else (embeddings, heads,
# the block's global-side denses, the vectors) is dequantized per call.
_INKERNEL_QUANT_KEYS = (
    ("narrow_conv", "kernel"),
    ("wide_conv", "kernel"),
    ("local_dense", "kernel"),
    ("attention", "wq"),
    ("attention", "wk"),
    ("attention", "wv"),
)


def partial_dequantize_params(qparams: Any) -> Any:
    """Quantized tree → the form the int8 arm runs: every quant leaf
    dequantized EXCEPT the block weights of `_INKERNEL_QUANT_KEYS`, which
    stay {"q", "scale"} for the int8 legs. (The JAX function's
    `use_pallas=False` branch, a full dequantize, has no counterpart: on
    the card the port always runs its kernels.)"""

    def walk(tree, path):
        if is_quant_leaf(tree):
            if "blocks" in path and path[-2:] in _INKERNEL_QUANT_KEYS:
                return tree
            return dequant_leaf(tree)
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        return tree

    return walk(qparams, ())


def param_bytes(params: Any) -> int:
    """numel · element_size summed over the tensors of a tree (a quant
    leaf counts q and scale; a tensor that several leaves share, once): the
    resident weight bytes."""
    seen = {}

    def add(t):
        seen[id(t)] = t.numel() * t.element_size()
        return t

    _tree_map(add, params)
    return sum(seen.values())


class QuantConfigError(ValueError):
    """A quantization knob was combined with a configuration or input it
    cannot honor (the JAX package's typed error: an unknown payload, a
    mesh without a replica reduction or with a model / seq axis, the
    explicit seq-parallel step with int8, an indivisible batch, a row
    batch that is not 2-D)."""


def quantize_rows_int8(x) -> Tuple["np.ndarray", "np.ndarray"]:
    """Symmetric per-channel int8 quantization of a ROW BATCH on the host
    — the JAX function's arithmetic exactly (amax/127 scales, `np.rint`
    round-to-nearest-even, zero-range channels pinned to scale 1.0), so
    an index built by either package has the same bytes. Host numpy on
    purpose: re-runs of the index builder must write byte-identical
    blocks. Returns (codes int8 (n, d), scales fp32 (d,))."""
    import numpy as np
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2:
        raise QuantConfigError(
            f"quantize_rows_int8 expects (rows, channels), got shape "
            f"{x.shape}")
    amax = np.max(np.abs(x), axis=0) if x.shape[0] else \
        np.zeros(x.shape[1], np.float32)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return codes, scale


def dequantize_rows_int8(codes, scale) -> "np.ndarray":
    """Inverse of quantize_rows_int8 (up to rounding): codes * scale,
    fp32 — the offline reference of the scorer's dequantize."""
    import numpy as np
    return (np.asarray(codes, np.float32)
            * np.asarray(scale, np.float32)[None, :])


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor symmetric int8 fake-quantization (the opt-in
    activation arm): quantize-dequantize, cast back to x's dtype."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return (torch.clamp(torch.round(xf / scale), -127, 127) * scale).to(
        x.dtype)


# ------------------------------------------------ the quantized entries
#
# Thin wrappers over the fp32 arm's entry bodies. The act variants
# re-compose encode + output heads with the trunk's output activations
# fake-quantized in between. They take `partial_dequantize_params` as the
# weight-only ones do, so the card runs the int8 legs on both arms (the
# JAX `_q_act_*` dequantize fully; the int8 legs give bit for bit the
# floating-point legs' output on the dequantized weights).


@torch.inference_mode()
def _q_encode_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return inference._encode_batch(partial_dequantize_params(qparams),
                                   tokens, annotations, cfg)


@torch.inference_mode()
def _q_go_probs_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return inference._go_probs_batch(partial_dequantize_params(qparams),
                                     tokens, annotations, cfg)


@torch.inference_mode()
def _q_residue_probs_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return inference._residue_probs_batch(
        partial_dequantize_params(qparams), tokens, annotations, cfg)


def _act_logits(params, tokens, annotations, cfg: ModelConfig):
    """models/proteinbert.apply with the trunk outputs fake-quantized
    before the output heads (the activation arm's cut point)."""
    local, global_ = proteinbert.encode(params, tokens, annotations, cfg)
    local = fake_quant_act(local)
    global_ = fake_quant_act(global_)
    local_logits = dense_apply(params["local_head"], local).float()
    global_logits = dense_apply(params["global_head"], global_).float()
    return local, global_, local_logits, global_logits


@torch.inference_mode()
def _q_act_encode_batch(qparams, tokens, annotations, cfg: ModelConfig):
    params = partial_dequantize_params(qparams)
    local, global_, _, _ = _act_logits(params, tokens, annotations, cfg)
    mask = (tokens != PAD_ID).float()[:, :, None]
    local = local.float()
    return {"local_mean": (local * mask).sum(1) / mask.sum(1).clamp_min(1.0),
            "global": global_.float()}


@torch.inference_mode()
def _q_act_go_probs_batch(qparams, tokens, annotations, cfg: ModelConfig):
    params = partial_dequantize_params(qparams)
    _, _, _, gl = _act_logits(params, tokens, annotations, cfg)
    return torch.sigmoid(gl)


@torch.inference_mode()
def _q_act_residue_probs_batch(qparams, tokens, annotations,
                               cfg: ModelConfig):
    params = partial_dequantize_params(qparams)
    _, _, ll, _ = _act_logits(params, tokens, annotations, cfg)
    return torch.softmax(ll, -1)


@torch.inference_mode()
def _q_packed_encode_batch(qparams, tokens, segment_ids, annotations,
                           cfg: ModelConfig):
    return inference._packed_encode_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


@torch.inference_mode()
def _q_packed_go_probs_batch(qparams, tokens, segment_ids, annotations,
                             cfg: ModelConfig):
    return inference._packed_go_probs_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


@torch.inference_mode()
def _q_packed_residue_probs_batch(qparams, tokens, segment_ids, annotations,
                                  cfg: ModelConfig):
    return inference._packed_residue_probs_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


@torch.inference_mode()
def _q_trunk_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return heads_apply.trunk_batch(partial_dequantize_params(qparams),
                                   tokens, annotations, cfg)


@torch.inference_mode()
def _q_packed_trunk_batch(qparams, tokens, segment_ids, annotations,
                          cfg: ModelConfig):
    return heads_apply.packed_trunk_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


def quant_entry(kind: str, act: bool = False):
    """The quantized entry for one request kind (bucketed path);
    activation fake-quant with `act`."""
    table = {
        ("embed", False): _q_encode_batch,
        ("predict_go", False): _q_go_probs_batch,
        ("predict_residues", False): _q_residue_probs_batch,
        ("embed", True): _q_act_encode_batch,
        ("predict_go", True): _q_act_go_probs_batch,
        ("predict_residues", True): _q_act_residue_probs_batch,
    }
    try:
        return table[(kind, act)]
    except KeyError:
        raise ValueError(f"no quantized entry for request kind {kind!r} "
                         f"(act={act})") from None


def quant_packed_entry(kind: str):
    """The quantized packed entry for one request kind (ragged path)."""
    table = {
        "embed": _q_packed_encode_batch,
        "predict_go": _q_packed_go_probs_batch,
        "predict_residues": _q_packed_residue_probs_batch,
    }
    try:
        return table[kind]
    except KeyError:
        raise ValueError(f"no quantized packed entry for request kind "
                         f"{kind!r}") from None


# ------------------------------------------- quantized reduce-scatter

# Payload dtypes of the quantized reduce-scatter ("fp32" is the unrounded
# measurement/control baseline, not a config value).
WIRE_PAYLOADS = ("fp32", "bf16", "int8")

# Elements per int8 scale block: one fp32 scale per QUANT_CHUNK payload
# elements is <1% wire overhead while one outlier cannot crush a whole
# slice's resolution.
QUANT_CHUNK = 512


def stochastic_round_bf16(x: torch.Tensor,
                          gen: torch.Generator) -> torch.Tensor:
    """fp32 → bf16, rounded stochastically: uniform 16-bit noise added to
    the fp32 bit pattern, then truncated to its top 16 bits — P(round up)
    is the discarded fraction, so the rounding is unbiased."""
    bits = torch.randint(0, 1 << 16, x.shape, generator=gen,
                         device=x.device, dtype=torch.int32)
    u = x.float().contiguous().view(torch.int32)
    return ((u + bits) & -65536).view(torch.float32).to(torch.bfloat16)


def quantize_int8_chunks(x: torch.Tensor, gen: Optional[torch.Generator],
                         chunk: int = QUANT_CHUNK):
    """(..., m) fp32 → (int8 payload (..., k, c), fp32 scales (..., k), m):
    k = ceil(m / chunk) near-equal blocks of c = ceil(m / k) elements (a
    16-element slice is one block of 16, not a padded 512), a symmetric
    scale amax/127 each; stochastic floor(y + u) with a generator,
    round-to-nearest-even without."""
    m = x.shape[-1]
    k = max(1, -(-m // chunk))
    c = -(-m // k)
    pad = k * c - m
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xc = x.reshape(*x.shape[:-1], k, c)
    amax = xc.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    y = xc / scale[..., None]
    if gen is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=gen,
                                       device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale, m


def dequantize_int8_chunks(q: torch.Tensor, scale: torch.Tensor,
                           m: int) -> torch.Tensor:
    """Inverse of quantize_int8_chunks (the trailing pad dropped)."""
    full = q.float() * scale[..., None]
    return full.reshape(*full.shape[:-2], -1)[..., :m]


def check_quant_mesh(mesh, payload: str,
                     batch_size: Optional[int] = None) -> int:
    """Validate a quantized-reduction request against `mesh` (anything
    with a `.shape` dict); returns the joint replica extent. Raises the
    typed QuantConfigError otherwise."""
    if payload not in WIRE_PAYLOADS:
        raise QuantConfigError(
            f"unknown quantized-reduction payload {payload!r}; "
            f"expected one of {WIRE_PAYLOADS}")
    from proteinbert_tpu_torch.parallel.zero import zero_extent

    joint = zero_extent(mesh)
    if joint <= 1:
        raise QuantConfigError(
            "quantized gradient reduction needs data*fsdp > 1 — there "
            "is no cross-replica reduction to compress on this mesh")
    for ax in ("model", "seq"):
        if mesh.shape.get(ax, 1) > 1:
            raise QuantConfigError(
                f"grad_reduce_dtype={payload!r} runs the forward/"
                f"backward inside an explicit data-parallel shard_map "
                f"and cannot shard the {ax!r} axis (extent "
                f"{mesh.shape[ax]}); use grad_reduce_dtype='fp32' (or "
                f"'bf16' numerics-only under the explicit seq-parallel "
                f"step) on model/seq-parallel meshes")
    if batch_size is not None and batch_size % joint:
        raise QuantConfigError(
            f"global batch {batch_size} does not split evenly over the "
            f"data*fsdp extent {joint} — the quantized step shards the "
            f"batch explicitly")
    return joint


def quant_reduce_scatter(layout, partials, payload: str,
                         gen: Optional[torch.Generator], registry=None):
    """The quantized reduce-scatter of per-rank partial gradients over
    `layout`'s replica group → (gradients aligned with `layout.views`,
    the global norm of the dequantized sum)."""
    from proteinbert_tpu_torch.parallel.zero import all_to_all

    d = layout.d
    xs = {i: layout.slices(partials[i], i).float() for i in layout.sharded}
    scales = {}
    if payload == "int8":
        pays = {}
        for i, x in xs.items():
            q, scales[i], _ = quantize_int8_chunks(x, gen)
            pays[i] = q.reshape(d, -1)
    elif payload == "bf16":
        pays = {i: stochastic_round_bf16(x, gen) for i, x in xs.items()}
    else:
        pays = xs
    order = layout.sharded
    send = torch.cat([pays[i] for i in order], dim=1)
    recv = all_to_all(torch.empty_like(send), send, layout.group, registry)
    if payload == "int8":
        sc_send = torch.cat([scales[i] for i in order], dim=1)
        sc_recv = all_to_all(torch.empty_like(sc_send), sc_send,
                             layout.group, registry)
    shards = {}
    off = off_sc = 0
    for i in order:
        m = xs[i].shape[1]
        width = pays[i].shape[1]
        got = recv[:, off:off + width]
        if payload == "int8":
            k = scales[i].shape[1]
            sc = sc_recv[:, off_sc:off_sc + k]
            red = (got.reshape(d, k, -1).float() * sc[..., None]).sum(0)
            red = red.reshape(-1)[:m]
            off_sc += k
        else:
            red = got.float().sum(0)
        shards[i] = red.view(layout.moved_shape[i]).movedim(
            0, layout.dims[i])
        off += width
    return layout.finish(partials, shards, registry)


class FsdpQuantLayout:
    """`quant_reduce_scatter`'s view of a data × fsdp mesh's
    `fsdp.MeshLayout` under ZeRO-1 (model = seq = 1): which leaves go
    through the quantized all_to_all over the joint data·fsdp group, and
    where each reduced slice lands.

    A leaf whose ZeRO piece is a clean joint-axis slice — an fsdp-stored
    leaf whose fsdp dim the rule widens to ('data', 'fsdp'), or a whole
    leaf with the joint axis on a free dim (the JAX `_leaf_plan`'s
    "alltoall" case) — is cut into data·fsdp slices along that dim. The
    layout keeps rank (d, f)'s piece inside its own fsdp shard (piece
    f·data + d of the dim, `fsdp.plan_leaf`) where the joint axis orders
    ranks d·fsdp + f, so an fsdp-stored leaf's slices are permuted before
    the exchange: the rank at joint index d·fsdp + f receives slice
    f·data + d. A whole leaf's slice r goes to joint rank r. Every other
    leaf (the rules' remainder) is summed in fp32 with one all-reduce
    and cut to this rank's piece, as JAX's "psum" case is."""

    def __init__(self, layout):
        mesh = layout.mesh
        self.layout = layout
        self.group = mesh.replica_group
        self.d = mesh.data_extent
        data, fsdp = mesh.shape["data"], mesh.shape["fsdp"]
        self.perm = torch.tensor([(r % fsdp) * data + r // fsdp
                                  for r in range(self.d)])
        self.sharded, self.permuted = [], set()
        self.dims, self.moved_shape = {}, {}
        for i, p in enumerate(layout.plans):
            z = p.zero
            if z is None or p.zero_slice:
                continue
            if p.store is not None and p.store == ("fsdp", z[1]):
                self.permuted.add(i)
            elif z[0] != "replica" or p.store is not None:
                continue
            dim = z[1]
            self.sharded.append(i)
            self.dims[i] = dim
            self.moved_shape[i] = (p.full_shape[dim] // self.d,) + tuple(
                n for j, n in enumerate(p.full_shape) if j != dim)
        self.rest = [i for i in range(len(layout.plans))
                     if i not in self.dims]

    def slices(self, g: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's full-shape partial as (data·fsdp, m): row r is the
        slice that joint rank r receives."""
        rows = g.movedim(self.dims[i], 0).reshape(self.d, -1)
        if i in self.permuted:
            rows = rows.index_select(0, self.perm.to(rows.device))
        return rows

    def finish(self, partials, shards, registry=None):
        """The remainder's fp32 all-reduce, with the shards' sum of
        squares in the same call → (each leaf's gradient at this rank's
        piece, aligned with `MeshLayout.views`; the global norm of the
        dequantized sum)."""
        from proteinbert_tpu_torch.parallel.fsdp import _narrow
        from proteinbert_tpu_torch.parallel.zero import all_reduce_flat

        sq = torch.zeros(1, dtype=torch.float32, device=partials[0].device)
        for t in shards.values():
            sq += (t.float() ** 2).sum()
        *rest, sq = all_reduce_flat([partials[i].float() for i in self.rest]
                                    + [sq], self.group, registry)
        grads = [None] * len(partials)
        for i, g in zip(self.rest, rest):
            sq = sq + (g ** 2).sum()
            p = self.layout.plans[i]
            if p.store is not None:
                g = _narrow(g, p.store[1], p.store_extent, p.store_index)
            if p.zero is not None:
                g = _narrow(g, *p.zero[1:])
            grads[i] = g
        for i, t in shards.items():
            grads[i] = t
        return grads, torch.sqrt(sq[0])


def make_quant_fsdp_train_step(mesh, cfg, payload: Optional[str] = None,
                               registry=None):
    """`step(state, batch, plateau_value=None) → (state, metrics)` on a
    data × fsdp mesh (fsdp > 1, model = seq = 1) under ZeRO-1 with a
    quantized gradient reduction — `fsdp.make_sharded_train_step`'s route
    for grad_reduce_dtype in {"bf16", "int8"} (JAX quant.py:256-300,
    where the same step runs on whatever layout the params have).

    The forward and backward run on the params gathered to full shape
    (`MeshLayout.full_params`, outside autograd, so no reduce-scatter
    follows the backward): each rank's gradient is its share of the
    global loss over its rows, the weight masses summed over the joint
    data·fsdp group first (`train_state.replica_loss_and_grads`). Those
    partials go through `quant_reduce_scatter` over `FsdpQuantLayout`
    (noise from `replica_generators(..., ("corrupt", "noise"))`), Adam
    updates this rank's ZeRO pieces in place, and one all-gather a ZeRO
    group writes the pieces back into the fsdp shards
    (`MeshLayout.gather_updated`). The state is this rank's shards
    (`TrainState.layout`), the moments at their ZeRO pieces, as on the
    fp32 sharded step; `step.layout_for(state)` gives the layout.
    `payload` overrides the wire dtype ("fp32" = the unrounded
    control)."""
    from proteinbert_tpu_torch.parallel.fsdp import (
        apply_update, layout_getter,
    )
    from proteinbert_tpu_torch.train import train_state as ts

    payload = payload or cfg.parallel.grad_reduce_dtype
    check_quant_mesh(mesh, payload, cfg.data.batch_size)
    layout_for = layout_getter(mesh, True, registry)
    cache = {}

    def step(state, batch, plateau_value=None):
        layout = layout_for(state)
        state = layout.shard_state(state)
        if cache.get("quant") is None or cache["quant"].layout is not layout:
            cache["quant"] = FsdpQuantLayout(layout)
        corrupt_gen, noise_gen = ts.replica_generators(
            state, mesh, ("corrupt", "noise"))
        X, Y, W, seg = ts.corrupt_for_step(state, batch, cfg, corrupt_gen)
        partials, metrics = ts.replica_loss_and_grads(
            layout.full_params(state.params), X, Y, W, cfg, seg,
            mesh.replica_group, registry)
        pieces, norm = quant_reduce_scatter(
            cache["quant"], partials, payload,
            None if payload == "fp32" else noise_gen, registry)
        del partials
        return apply_update(layout, cfg, state, pieces, norm, metrics,
                            plateau_value)

    step.layout_for = layout_for
    return step


def make_quant_zero_train_step(mesh, cfg, payload: Optional[str] = None,
                               registry=None):
    """`step(state, batch, plateau_value=None) → (state, metrics)`: the
    ZeRO-1 step whose gradient reduction is the quantized reduce-scatter
    above — the `make_zero_train_step` route for grad_reduce_dtype in
    {"bf16", "int8"}; `payload` overrides the wire dtype ("fp32" = the
    unrounded control). Same signature and plateau contract as the fp32
    ZeRO step."""
    from proteinbert_tpu_torch.parallel.zero import layout_for, zero_apply
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import effective_lr

    payload = payload or cfg.parallel.grad_reduce_dtype
    check_quant_mesh(mesh, payload, cfg.data.batch_size)
    cache = {}

    def step(state, batch, plateau_value=None):
        corrupt_gen, noise_gen = ts.replica_generators(
            state, mesh, ("corrupt", "noise"))
        partials, metrics = ts.corrupt_replica_grads(
            state, batch, cfg, mesh, registry, generator=corrupt_gen)
        layout = layout_for(cache, mesh, state.params)
        grads, norm = quant_reduce_scatter(
            layout, partials, payload,
            None if payload == "fp32" else noise_gen, registry)
        metrics["grad_norm"] = norm
        value = ts.plateau_observation(cfg.optimizer, metrics, plateau_value)
        opt_state = zero_apply(layout, cfg.optimizer, grads, state.opt_state,
                               value, norm, registry)
        metrics["lr"] = effective_lr(cfg.optimizer, opt_state, state.step)
        return ts.TrainState(state.step + 1, state.params, opt_state,
                             state.generator), metrics

    return step
