"""The spatial (height-sharded) half of the mesh (parity: the JAX package's
``make_train_step(spatial=True)``, parallel/steps.py:100-101 and
:203-206, whose ``P('data', 'spatial')`` sharding has XLA insert the
halo exchanges and the global reductions for any model the step takes).

The ranks of one data row (``axis``: ``mesh.axis('spatial')``) each hold
an equal band of rows of every image of that row: rank q of n holds the
global rows ``[q h, (q + 1) h)`` of an H = n h tensor. Under
``spatial_rows(model, axis)`` DeepLab (MobileNetV2, ResNet-50/101; os16
and os8), ENet, FastSCNN and the UNet run their forward on such bands
and compute what the unsharded forward computes on the whole image (the
model files say where). The primitives:

* ``shard_rows``: this rank's rows of an image, refusing a height that
  does not split into equal bands at every stride of the model
  (``row_multiple``).
* ``fetch_rows``: global rows ``[a, b)`` of a sharded tensor, its own
  band and the halo its neighbours (or ranks further off) hold; rows
  outside the tensor are zero.
* ``sharded_conv``: a conv over the global rows, halo fetched first.
* ``sharded_max_pool``: the 3x3 / stride 2 / padding 1 max pool, one halo
  row above, -inf above the global top only (and ENet's window-offset
  selector counted on the fetched rows).
* ``sharded_conv_transpose``: the 3x3 / stride 2 / padding 1 / output
  padding 1 transposed conv, one halo row below.
* ``row_below``: a band with the next global row under it (ENet's
  unpool reads window i + 1), a fill past the global bottom; an integer
  tensor (the int8 selector) crosses exactly, without a gradient.
* ``spatial_mean``: the mean over the global rows and every column.
* ``band_adaptive_pool``: an adaptive average pool of the global rows
  (FastSCNN's pyramid), the same small map on every rank of the row.
* ``resize_rows``: the align-corners bilinear resize in global row
  coordinates (a band's output rows read source rows across its edge);
  the columns resize locally. ``resize_replicated`` takes this rank's
  rows of the resize of a map every rank holds whole.

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

# a band's rows must split equally at every stride-2 stage: a multiple of
# the network's largest stride (DeepLab's is its output stride; 16, the
# canonical os16 network's, is the default of ``shard_rows``)
ROW_MULTIPLE = 16
ROW_MULTIPLES = {"enet": 8, "fastscnn": 32, "unet": 8}

Span = Tuple[int, int]


def shard_rows(height: int, mesh, multiple: int = ROW_MULTIPLE) -> Span:
    """(start, end) of this rank's rows of an image ``height`` rows high,
    on ``mesh`` (any mesh: its ``spatial_rank`` of ``spatial_world``);
    ``multiple``: the model's ``row_multiple``. Raises a ``ValueError``
    unless ``height % (spatial * multiple) == 0`` (the counterpart of
    JAX's ``device_put`` refusing 513 rows on 2 spatial devices)."""
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


def sharded_max_pool(x: torch.Tensor, axis, selector: bool = False):
    """``MaxPool2d(3, 2, 1)`` over the global rows of the height-sharded
    ``x``: each rank's output band reads its rows and one halo row above,
    -inf above the global top (the pool's padding) and the neighbour's
    real row elsewhere. ``selector``: also return ENet's int8 offset
    ``3 dr + dc`` of each window's first maximum (``models.enet``), counted
    on the fetched rows, where window r starts at row 2r (global 2R - 1),
    so the offsets are the whole image's."""
    n, r, h = axis.world, axis.rank, x.shape[2]
    rows = fetch_rows(x, axis, equal_bands(h, n),
                      [(max(q * h - 1, 0), (q + 1) * h) for q in range(n)])
    if r == 0:
        rows = F.pad(rows, (0, 0, 1, 0), value=float("-inf"))
    if not selector:
        return F.max_pool2d(rows, 3, 2, (0, 1))
    pooled, flat = F.max_pool2d(rows, 3, 2, (0, 1), return_indices=True)
    w = x.shape[3]
    dr = flat // w - 2 * torch.arange(pooled.shape[2], device=x.device)[:, None]
    dc = flat % w - 2 * torch.arange(pooled.shape[3], device=x.device) + 1
    return pooled, (3 * dr + dc).to(torch.int8)


def sharded_conv_transpose(tconv, x: torch.Tensor, axis) -> torch.Tensor:
    """``tconv`` (an ``nn.ConvTranspose2d(k=3, stride 2, padding 1, output
    padding 1)``, which doubles the rows) over the global rows of the
    height-sharded ``x``: output rows [2s, 2e) read input rows [s, e + 1),
    one halo row below (zero past the global bottom). Transposed with row
    padding 1 and no output padding, the h + 1 fetched rows give 2h + 1
    rows whose first 2h are this rank's."""
    if (tconv.kernel_size[0], tconv.stride[0], tconv.padding[0],
            tconv.output_padding[0], tconv.dilation[0]) != (3, 2, 1, 1, 1):
        raise NotImplementedError(f"a height-sharded {tconv}")
    h = x.shape[2]
    rows = row_below(x, axis)
    y = F.conv_transpose2d(rows, tconv.weight, tconv.bias, tconv.stride, tconv.padding,
                           (0, tconv.output_padding[1]), tconv.groups, tconv.dilation)
    return y[:, :, :2 * h]


def row_below(x: torch.Tensor, axis, fill: float = 0) -> torch.Tensor:
    """This rank's band of the height-sharded ``x`` with the next global
    row under it: the next band's first row, or ``fill`` below the global
    bottom. An integer tensor (ENet's int8 selector) crosses exactly (the
    f32 buffer holds it) and carries no gradient."""
    n, r, h = axis.world, axis.rank, x.shape[2]
    wants = [(q * h, min((q + 1) * h + 1, n * h)) for q in range(n)]
    with torch.set_grad_enabled(torch.is_grad_enabled() and x.is_floating_point()):
        rows = fetch_rows(x, axis, equal_bands(h, n), wants)
    if r == n - 1:
        rows = F.pad(rows, (0, 0, 0, 1), value=fill)
    return rows


def spatial_mean(x: torch.Tensor, axis) -> torch.Tensor:
    """(B, C, 1, 1): the mean of the height-sharded ``x`` over the global
    rows and every column (ASPP's global average pool), on every rank of
    the row; its backward is a sum over the row (``cross_replica_sum``)."""
    total = x.sum(dim=(2, 3), keepdim=True, dtype=_transport(x.dtype))
    count = x.shape[2] * axis.world * x.shape[3]
    return (cross_replica_sum(total, axis) / count).to(x.dtype)


def band_adaptive_pool(x: torch.Tensor, rows_matrix: torch.Tensor,
                       cols_matrix: torch.Tensor, axis) -> torch.Tensor:
    """(B, C, p, q): an adaptive average pool of the height-sharded ``x``
    over the global rows, the same map on every rank of the row.
    ``rows_matrix`` (p, H) averages the H = n h global rows,
    ``cols_matrix`` (q, w) the columns: each rank multiplies its rows'
    columns of ``rows_matrix`` with its band, and the row's ranks sum
    the products (``cross_replica_sum``, in the matrices' dtype, also
    where autocast forms the products in bf16)."""
    h, r = x.shape[2], axis.rank
    part = torch.einsum("ph,bchw,qw->bcpq", rows_matrix[:, r * h:(r + 1) * h],
                        x.to(rows_matrix.dtype), cols_matrix)
    return cross_replica_sum(part.to(rows_matrix.dtype), axis).to(x.dtype)


def _sources(in_rows: int, out_rows: int, q: int, per: int):
    """(i0, i1, frac) of output rows [q per, (q + 1) per) of an
    align-corners resize from ``in_rows`` to ``out_rows`` global rows."""
    scale = (in_rows - 1) / (out_rows - 1) if out_rows > 1 else 0.0
    src = np.arange(q * per, (q + 1) * per) * scale
    i0 = np.minimum(np.floor(src).astype(np.int64), in_rows - 1)
    return i0, np.minimum(i0 + 1, in_rows - 1), src - i0


def _lerp(rows: torch.Tensor, i0, i1, frac, out_w: int) -> torch.Tensor:
    """Output rows ``rows[i0] (1 - frac) + rows[i1] frac``, then the
    columns resized to ``out_w`` (align corners), locally."""
    dev, dt = rows.device, rows.dtype
    f = torch.as_tensor(frac, dtype=dt, device=dev).view(1, 1, -1, 1)
    g = torch.as_tensor(1.0 - frac, dtype=dt, device=dev).view(1, 1, -1, 1)
    y = (rows.index_select(2, torch.as_tensor(i0, device=dev)) * g
         + rows.index_select(2, torch.as_tensor(i1, device=dev)) * f)
    if out_w != rows.shape[3]:
        b, c, out_h = y.shape[:3]
        y = F.interpolate(y.reshape(b, c * out_h, rows.shape[3]), size=out_w,
                          mode="linear", align_corners=True).reshape(b, c, out_h, out_w)
    return y


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
    return _lerp(rows, i0 - a, i1 - a, frac, out_w)


def resize_replicated(x: torch.Tensor, out_h: int, out_w: int, axis) -> torch.Tensor:
    """This rank's ``out_h`` rows of the align-corners bilinear resize of
    ``x``, which every rank of the row holds whole (a pooled map), to
    ``out_h * n`` by ``out_w``: local, no exchange."""
    i0, i1, frac = _sources(x.shape[2], out_h * axis.world, axis.rank, out_h)
    return _lerp(x, i0, i1, frac, out_w)


def row_multiple(model) -> int:
    """The rows a band of ``model``'s input must be a multiple of: its
    largest stride (DeepLab's output stride, 16 or 8; ENet 8; FastSCNN
    32; the UNet 8)."""
    name = getattr(model, "model_name", type(model).__name__)
    if name == "deeplab":
        return model.output_stride
    return ROW_MULTIPLES[name]


def check_band(model, rows: int) -> None:
    """Raise a ``ValueError`` unless a band of ``rows`` rows splits at
    every stride of ``model``."""
    multiple = row_multiple(model)
    if rows % multiple:
        raise ValueError(f"a band of {rows} rows: the spatial step needs height "
                         f"% (spatial * {multiple}) == 0")


def check_model(model) -> None:
    """Raise ``NotImplementedError`` unless ``model`` has a height-sharded
    forward: every model JAX's ``make_train_step(spatial=True)`` takes
    (DeepLab with any backbone, ENet, FastSCNN, the UNet). The two-headed
    accuracy predictor has none, as in the JAX package."""
    name = getattr(model, "model_name", type(model).__name__)
    if name == "deeplab" or name in ROW_MULTIPLES:
        return
    if name == "accuracy_predictor":
        raise NotImplementedError(
            "the two-headed accuracy predictor has no spatial (height-sharded) "
            "step: the JAX package's make_dual_train_step shards the batch over "
            "'data' only and takes no spatial argument, and its make_train_step"
            "(spatial=True) cannot take a model with two heads")
    raise NotImplementedError(f"{name} has no spatial (height-sharded) forward")


@contextlib.contextmanager
def spatial_rows(model, axis):
    """For the length of a ``with`` block, ``model``'s forward takes the
    height-sharded band of each image on every rank of ``axis`` (the
    module docstring): every module with a ``shard`` attribute (the
    convs, pools and transposed convs, the inverted residuals' fixed
    padding, the global and adaptive pools, the resizes, ENet's unpool)
    gets ``axis``. A one-rank axis (or
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
