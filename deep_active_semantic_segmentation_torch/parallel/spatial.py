"""The spatial (height-sharded) half of the mesh (parity: the JAX package's
``make_train_step(spatial=True)``, parallel/steps.py:100-101 and
:203-206, whose ``P('data', 'spatial')`` sharding has XLA insert the conv
halo exchanges and the global reductions).

The ranks of one data row (``axis``: ``mesh.axis('spatial')``) each hold
an equal band of rows of every image of that row: rank q of n holds the
global rows ``[q h, (q + 1) h)`` of an H = n h tensor. Under
``spatial_rows(model, axis)`` DeepLab-MobileNetV2 runs its forward on
such bands and computes what the unsharded forward computes on the whole
image (the model files say where). The primitives:

* ``shard_rows``: this rank's rows of an image, refusing a height that
  does not split into equal bands at every stride of the os16 network.
* ``fetch_rows``: global rows ``[a, b)`` of a sharded tensor, its own
  band and the halo its neighbours (or ranks further off) hold; rows
  outside the tensor are zero.
* ``sharded_conv``: a conv over the global rows, halo fetched first.
* ``spatial_mean``: the mean over the global rows and every column.
* ``resize_rows``: the align-corners bilinear resize in global row
  coordinates (a band's output rows read source rows across its edge);
  the columns resize locally.

Transport: each exchange is one all-reduce, over the row's ranks, of a
zero buffer into which every row is written by its one owner, so rows
arrive exactly (x + 0 = x) as in ``Mesh.gather_rows``: gloo runs only
all_reduce and broadcast on CUDA tensors, and one path serves gloo on
the CPU, gloo on a shared card and NCCL. Each primitive is an autograd
function whose backward is its forward's adjoint (a halo row's gradient
goes back to its owner and is added there), with
``crossreplica.cross_replica_sum``'s convention: every rank computes the
same global loss, and DistributedDataParallel's mean over the world of
the ranks' partial gradients is the global loss's gradient.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
    cross_replica_sum)

# the network's largest stride (MobileNetV2 at output stride 16): each
# band must split equally at every stride-2 stage and at the os16 map
ROW_MULTIPLE = 16

# the ROADMAP items that will give each model its height-sharded forward
NOT_PORTED = {"deeplab": "A15c (DeepLab-ResNet)", "enet": "A15d (ENet)",
              "fastscnn": "A15e (FastSCNN)", "unet": "A15f (UNet)",
              "accuracy_predictor": "A15g (the two-headed accuracy predictor)"}

Span = Tuple[int, int]


def shard_rows(height: int, mesh, multiple: int = ROW_MULTIPLE) -> Span:
    """(start, end) of this rank's rows of an image ``height`` rows high,
    on ``mesh`` (any mesh: its ``spatial_rank`` of ``spatial_world``).
    Raises a ``ValueError`` unless ``height % (spatial * multiple) == 0``
    (the counterpart of JAX's ``device_put`` refusing 513 rows on 2
    spatial devices)."""
    n = mesh.spatial_world
    if height % (n * multiple):
        raise ValueError(f"a height of {height} does not split over {n} spatial "
                         f"ranks: the spatial step needs height % (spatial * "
                         f"{multiple}) == 0")
    per = height // n
    return mesh.spatial_rank * per, (mesh.spatial_rank + 1) * per


def _halo(own: Span, want: Span) -> Tuple[Span, Span]:
    """The rows of ``want`` above and below ``own`` (either may be empty)."""
    (s, e), (a, b) = own, want
    return (a, max(a, min(b, s))), (min(b, max(a, e)), b)


def _clip(want: Span, first: int, last: int) -> Span:
    """``want`` cut to the rows [first, last) that some rank holds."""
    a = min(max(want[0], first), last)
    return a, max(a, min(want[1], last))


def _slots(owns: List[Span], wants: List[Span]):
    """Every rank's halo spans (its wanted rows that other ranks hold)
    with their offsets in the exchange buffer: ([(rank, (a, b), offset)],
    rows in all)."""
    slots, offset = [], 0
    for q, (own, want) in enumerate(zip(owns, wants)):
        for a, b in _halo(own, _clip(want, owns[0][0], owns[-1][1])):
            if b > a:
                slots.append((q, (a, b), offset))
                offset += b - a
    return slots, offset


def _transport(dtype: torch.dtype) -> torch.dtype:
    """The buffer's dtype: f32 for narrower floats (bf16 under autocast;
    widened exactly), the tensor's own otherwise."""
    return torch.promote_types(dtype, torch.float32)


def _rows_like(x: torch.Tensor, n: int, dtype=None) -> torch.Tensor:
    return x.new_zeros(x.shape[:2] + (n, x.shape[3]), dtype=dtype or x.dtype)


class _FetchRows(torch.autograd.Function):
    """The result's rows, top to bottom: zeros above the tensor, the halo
    above this rank's band, the band's wanted rows, the halo below, zeros
    below the tensor."""

    @staticmethod
    def forward(ctx, x, axis, owns, wants):
        (s, e), (a, b) = owns[axis.rank], wants[axis.rank]
        ca, cb = _clip((a, b), owns[0][0], owns[-1][1])
        top, bottom = _halo((s, e), (ca, cb))
        lo = max(ca, s)
        hi = max(lo, min(cb, e))
        slots, total = _slots(owns, wants)
        ctx.axis, ctx.own, ctx.slots, ctx.total = axis, (s, e), slots, total
        ctx.spans = {"top": top, "bottom": bottom}
        ctx.at = {"top": ca - a, "mid": ca - a + top[1] - top[0]}
        ctx.at["bottom"] = ctx.at["mid"] + hi - lo
        ctx.mid = (lo - s, hi - s)
        buf = None
        if total:
            buf = _rows_like(x, total, _transport(x.dtype))
            for _, (qa, qb), off in slots:      # the rows this rank holds
                r0, r1 = max(qa, s), min(qb, e)
                if r1 > r0:
                    buf[:, :, off + r0 - qa:off + r1 - qa] = x[:, :, r0 - s:r1 - s]
            axis.all_reduce(buf)
        mine = {span: off for q, span, off in slots if q == axis.rank}
        pieces = [_rows_like(x, ca - a)]
        if top[1] > top[0]:
            pieces.append(buf[:, :, mine[top]:mine[top] + top[1] - top[0]].to(x.dtype))
        pieces.append(x[:, :, lo - s:hi - s])
        if bottom[1] > bottom[0]:
            off = mine[bottom]
            pieces.append(buf[:, :, off:off + bottom[1] - bottom[0]].to(x.dtype))
        pieces.append(_rows_like(x, b - cb))
        return torch.cat(pieces, dim=2)

    @staticmethod
    def backward(ctx, grad):
        (s, e), axis = ctx.own, ctx.axis
        m0, m1 = ctx.mid
        dx = _rows_like(grad, e - s)
        dx[:, :, m0:m1] = grad[:, :, ctx.at["mid"]:ctx.at["mid"] + m1 - m0]
        if not ctx.total:
            return dx, None, None, None
        buf = _rows_like(grad, ctx.total, _transport(grad.dtype))
        for q, span, off in ctx.slots:   # this rank's halo gradients
            if q == axis.rank:
                at = ctx.at["top" if span == ctx.spans["top"] else "bottom"]
                buf[:, :, off:off + span[1] - span[0]] = grad[:, :, at:at + span[1] - span[0]]
        axis.all_reduce(buf)
        for _, (qa, qb), off in ctx.slots:   # every halo row this rank holds
            r0, r1 = max(qa, s), min(qb, e)
            if r1 > r0:
                dx[:, :, r0 - s:r1 - s] += buf[:, :, off + r0 - qa:off + r1 - qa].to(
                    dx.dtype)
        return dx, None, None, None


def fetch_rows(x: torch.Tensor, axis, owns: List[Span],
               wants: List[Span]) -> torch.Tensor:
    """The global rows ``wants[axis.rank]`` = [a, b) of the NCHW tensor
    whose rows ``owns[q]`` rank q of ``axis`` holds (``x``: this rank's;
    the bands in rank order, adjacent). Rows outside every band are
    zero. Every rank passes the same ``owns`` and ``wants``; a halo may
    reach past the next rank's band."""
    return _FetchRows.apply(x, axis, owns, wants)


def equal_bands(rows: int, n: int) -> List[Span]:
    return [(q * rows, (q + 1) * rows) for q in range(n)]


def sharded_conv(conv, x: torch.Tensor, axis) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d``, zero padding) over the global rows of
    the height-sharded ``x``: each rank computes its equal band of the
    output rows. ``conv.edge_rows`` = (top, bottom): rows of padding that
    ``x`` already carries at the global top (rank 0) and bottom (the last
    rank), as ``layers.fixed_padding`` leaves them; the conv's own row
    padding is the fetch's zero rows. Raises where the output does not
    split equally."""
    k, stride = conv.kernel_size[0], conv.stride[0]
    dilation, pad = conv.dilation[0], conv.padding[0]
    top, bottom = conv.edge_rows
    n, r = axis.world, axis.rank
    h = x.shape[2] - (top if r == 0 else 0) - (bottom if r == n - 1 else 0)
    owns = [(q * h + (top if q else 0),
             (q + 1) * h + top + (bottom if q == n - 1 else 0)) for q in range(n)]
    out = (n * h + top + bottom + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    if out % n:
        raise ValueError(f"a conv's {out} output rows do not split over {n} "
                         "spatial ranks")
    per = out // n
    reach = dilation * (k - 1) + 1
    wants = [(q * per * stride - pad, ((q + 1) * per - 1) * stride - pad + reach)
             for q in range(n)]
    rows = fetch_rows(x, axis, owns, wants)
    return F.conv2d(rows, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


def spatial_mean(x: torch.Tensor, axis) -> torch.Tensor:
    """(B, C, 1, 1): the mean of the height-sharded ``x`` over the global
    rows and every column (ASPP's global average pool), on every rank of
    the row; its backward is a sum over the row (``cross_replica_sum``)."""
    total = x.sum(dim=(2, 3), keepdim=True, dtype=_transport(x.dtype))
    count = x.shape[2] * axis.world * x.shape[3]
    return (cross_replica_sum(total, axis) / count).to(x.dtype)


def _sources(in_rows: int, out_rows: int, q: int, per: int):
    """(i0, i1, frac) of output rows [q per, (q + 1) per) of an
    align-corners resize from ``in_rows`` to ``out_rows`` global rows."""
    scale = (in_rows - 1) / (out_rows - 1) if out_rows > 1 else 0.0
    src = np.arange(q * per, (q + 1) * per) * scale
    i0 = np.minimum(np.floor(src).astype(np.int64), in_rows - 1)
    return i0, np.minimum(i0 + 1, in_rows - 1), src - i0


def resize_rows(x: torch.Tensor, out_h: int, out_w: int, axis) -> torch.Tensor:
    """Bilinear align-corners resize of the height-sharded (B, C, h, w)
    ``x`` (global height h n) to this rank's ``out_h`` rows of the global
    ``out_h * n`` by ``out_w`` columns: the rows in global coordinates,
    each output row from its two source rows, wherever they lie; then
    the columns, locally."""
    n, r = axis.world, axis.rank
    h = x.shape[2]
    wants = []
    for q in range(n):
        i0, i1, _ = _sources(h * n, out_h * n, q, out_h)
        wants.append((int(i0[0]), int(i1[-1]) + 1))
    rows = fetch_rows(x, axis, equal_bands(h, n), wants)
    i0, i1, frac = _sources(h * n, out_h * n, r, out_h)
    a = wants[r][0]
    dev = x.device
    f = torch.as_tensor(frac, dtype=x.dtype, device=dev).view(1, 1, -1, 1)
    g = torch.as_tensor(1.0 - frac, dtype=x.dtype, device=dev).view(1, 1, -1, 1)
    y = (rows.index_select(2, torch.as_tensor(i0 - a, device=dev)) * g
         + rows.index_select(2, torch.as_tensor(i1 - a, device=dev)) * f)
    if out_w != x.shape[3]:
        b, c = y.shape[:2]
        y = F.interpolate(y.reshape(b, c * out_h, x.shape[3]), size=out_w,
                          mode="linear", align_corners=True).reshape(b, c, out_h, out_w)
    return y


def check_model(model) -> None:
    """Raise ``NotImplementedError`` unless ``model`` has a height-sharded
    forward (DeepLab-MobileNetV2, the model JAX's ``dryrun_multichip``
    runs), naming the ROADMAP item that will port it."""
    from deep_active_semantic_segmentation_torch.models.backbone.mobilenet import (
        MobileNetV2)

    name = getattr(model, "model_name", type(model).__name__)
    if name == "deeplab" and isinstance(model.backbone, MobileNetV2):
        return
    raise NotImplementedError(
        f"the spatial (height-sharded) step runs DeepLab-MobileNetV2 only; "
        f"{NOT_PORTED.get(name, name)} is not ported to it yet (ROADMAP)")


@contextlib.contextmanager
def spatial_rows(model, axis):
    """For the length of a ``with`` block, ``model``'s forward takes the
    height-sharded band of each image on every rank of ``axis`` (the
    module docstring): every module with a ``shard`` attribute (the
    convs, the inverted residuals' fixed padding, ASPP's pool, the
    decoder's and the head's resizes) gets ``axis``. A one-rank axis (or
    None) changes nothing."""
    if axis is None or axis.world == 1:
        yield
        return
    check_model(model)
    mods = [m for m in model.modules() if hasattr(type(m), "shard")]
    for m in mods:
        m.shard = axis
    try:
        yield
    finally:
        for m in mods:
            m.shard = None
