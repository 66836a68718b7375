"""Spatial sharding across processes: each rank of a spatial group holds a
slab of every sample along one spatial dim (the JAX package's
`ganslate_tpu/parallel/spatial.py`).

The JAX package partitions one compiled program over a `spatial` mesh axis
inside one process: GSPMD adds the conv halos and makes every norm
reduction global (`train.spatial_mesh`, `spatially_sharded_infer_gspmd`),
and `shard_map` runs the manual halo exchange of `spatially_sharded_infer`.
The port runs one process per rank, so the spatial axis crosses processes
(`communication.init_groups`), and the layers do explicitly what GSPMD does
there, inside `spatial_scope`:

- `Conv` and `ConvTranspose` (`nn/layers.py`) exchange the rows their
  window reaches across a shard boundary (`halo_exchange`) and convolve
  without padding along the sharded dim; `pad_spatial` takes the
  neighbour's rows on interior sides and reflects or replicates only at the
  global edges;
- instance norm takes the whole sample's statistics through the split
  kernels (`ops/instance_norm.py`), batch norm the world's;
- a loss is this rank's share of the global mean (`global_mean`: local sum
  over global count), so the spatial ranks' gradients sum to the unsharded
  gradient, and `total` sums the shares for reporting.

A layer whose output does not split evenly over the shards raises
(`uneven`), except where a network declares a replicated section: it
gathers its input along the sharded dim (`gather`) and runs on the whole
tensor on every rank (`suspended`). A replicated section ends in one of two
ways, so that the spatial group's sum of the gradients counts each
parameter once (`nn/gans/base.py` sums them over the group):
- in a loss that `global_mean` takes as this rank's share (the whole
  mean over the group's size): the PatchGAN's stride-1 tail, CUT's MLP
  head and PatchNCE after the indexed select (`select`);
- in `slab`, a narrow back to this rank's rows, whose backward keeps only
  those rows: the U-Net's and the V-Net's bottom levels.
The declared sections are the PatchGAN tail, the U-Net's and the V-Net's
bottoms, the attention's keys and values, the multi-scale discriminator's crop (which
`reslab` moves to even slabs of its rows where it can) and CUT's selected
patches; `COUNTS`, `BY_NETWORK` and `SITES` count their exchanges.

Transport: point-to-point through `dist.batch_isend_irecv`, and all-gather
and all-reduce over the spatial group. On gloo, whose point-to-point and
all-gather take CPU tensors only, CUDA tensors are staged through pinned
host buffers, as `parallel.mesh.all_gather_batch` does; on NCCL (one card
per rank) they go as they are.
"""

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ganslate_tpu_torch.parallel import mesh
from ganslate_tpu_torch.utils import communication

# Modules that only hold others (what they hold is checked), and
# position-wise modules, which act on the channels of each row alone.
_CONTAINERS = (nn.ModuleList, nn.ModuleDict, nn.Sequential)
_POSITIONWISE = (nn.Linear,)
_DECLARE = ("a class declares `spatially_sharded = True` where everything it computes is "
            "correct on a slab inside `spatial_scope` (train.spatial_mesh, spatial_sharding "
            "method 'gspmd')")


def check_sharded(model, networks):
    """Raise NotImplementedError naming the first of `model` (a GAN), its
    `networks` and the modules inside them that does not declare
    `spatially_sharded = True`. Every GAN family and network of the port
    declares it; a network that does not (a user's own) is refused here,
    before it could compute a slab's numbers as if they were a sample's."""
    if not getattr(model, "spatially_sharded", False):
        raise NotImplementedError(f"{type(model).__name__} is not spatially sharded: "
                                  f"{_DECLARE}")
    for name, net in networks.items():
        for m in net.modules():
            if isinstance(m, _CONTAINERS + _POSITIONWISE) \
                    or getattr(m, "spatially_sharded", False):
                continue
            what = f"{type(net).__name__} ({name})"
            if m is not net:
                what = f"{type(m).__name__} in {what}"
            raise NotImplementedError(f"{what} is not spatially sharded: {_DECLARE}")


#: Exchanges since `reset_counts()`: halo exchanges (each direction pair one),
#: gathers along the sharded dim, re-slabs (`reslab`), indexed selects
#: (`select`), and all-reduces over the spatial group.
COUNTS = {"halo": 0, "gather": 0, "reslab": 0, "select": 0, "all_reduce": 0}
#: The same counts by network: the name `BaseGAN.apply` gives the scope
#: (`SpatialScope.network`; "" for the losses and all outside a network).
#: An exchange of a backward counts under the network of its forward.
BY_NETWORK = {}
#: The declared replicated sections' exchanges since `reset_counts()`, by
#: site: 'patchgan_tail', 'unet_bottom', 'vnet_bottom', 'attention_kv',
#: 'multiscale_crop', 'cut_patches'.
SITES = {}
#: Their host seconds since `reset_counts()` (halo exchanges; gathers and
#: all-reduces as "collective"), read only where `TIMED` is set: then each
#: is timed between device synchronisations (a measurement's setting).
SECONDS = {"halo": 0.0, "collective": 0.0}
TIMED = False


def reset_counts():
    for name in COUNTS:
        COUNTS[name] = 0
    for name in SECONDS:
        SECONDS[name] = 0.0
    BY_NETWORK.clear()
    SITES.clear()


def _count(kind: str, scope: "SpatialScope", site: Optional[str] = None):
    COUNTS[kind] += 1
    by = BY_NETWORK.setdefault(scope.network, dict.fromkeys(COUNTS, 0))
    by[kind] += 1
    if site is not None:
        SITES[site] = SITES.get(site, 0) + 1


@contextlib.contextmanager
def _timed(kind: str, x: torch.Tensor):
    if not TIMED:
        yield
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        SECONDS[kind] += time.perf_counter() - t0


@dataclass(frozen=True)
class SpatialScope:
    """The ranks that share each sample, this rank's slab and the sharded
    dim. `spatial_dim` counts the spatial axes from 0, so the sharded dim
    is `2 + spatial_dim` of an `(N, C, *spatial)` tensor and `1 +
    spatial_dim` of a channels-last `(N, *spatial, C)` one. `sharded`:
    the tensors are slabs (False: every rank holds the whole sample, a leaf
    the shard rule replicates, and only the losses are shares). `network`:
    the network that runs in this scope, under which its exchanges are
    counted (`BY_NETWORK`)."""

    group: object
    ranks: Tuple[int, ...]
    index: int
    spatial_dim: int = 0
    sharded: bool = True
    network: str = ""

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` in place over the spatial group (gloo's own CUDA path for
        a CUDA tensor)."""
        _count("all_reduce", self)
        with _timed("collective", t):
            dist.all_reduce(t, group=self.group)
        return t

    def named(self, network: str) -> "SpatialScope":
        """This scope, counting its exchanges under `network`."""
        return dataclasses.replace(self, network=network)


_SCOPE: Optional[SpatialScope] = None


def make_scope(spatial_dim: int = 0, sharded: bool = True) -> Optional[SpatialScope]:
    """The scope of this rank's spatial group (`communication.init_groups`),
    or None where the group is this rank alone."""
    if communication.get_spatial_size() == 1:
        return None
    return SpatialScope(communication.get_spatial_group(),
                        tuple(communication.get_spatial_ranks()),
                        communication.get_spatial_rank(), spatial_dim, sharded)


@contextlib.contextmanager
def spatial_scope(scope: Optional[SpatialScope]):
    """Inside, the layers and losses treat their tensors as `scope` says
    (nothing changes for None), as `parallel.global_batch()` does for
    batch statistics."""
    global _SCOPE
    outer, _SCOPE = _SCOPE, scope
    try:
        yield
    finally:
        _SCOPE = outer


@contextlib.contextmanager
def suspended():
    """Inside, no scope: the whole, replicated tensors of a tail that runs
    on every rank."""
    with spatial_scope(None):
        yield


def current() -> Optional[SpatialScope]:
    """The scope in force, sharded or not."""
    return _SCOPE


def active() -> Optional[SpatialScope]:
    """The scope in force when its tensors are slabs, else None."""
    return _SCOPE if _SCOPE is not None and _SCOPE.sharded else None


def replicated(on: bool = True):
    """`suspended()` where `on`, else nothing: the scope of a section that
    a network runs replicated from some layer on."""
    return suspended() if on else contextlib.nullcontext()


def global_extent(shape, scope: Optional[SpatialScope] = None):
    """The whole sample's spatial extents of an `(N, C, *spatial)` slab: its
    own, with the sharded dim times the group's size in a sharded scope."""
    scope = scope or active()
    spatial = list(shape[2:])
    if scope is not None:
        spatial[scope.spatial_dim] *= scope.size
    return tuple(spatial)


# ---------------------------------------------------------------- transport


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`t` in `x`'s memory format (channels-last stays channels-last)."""
    if x.dim() in (4, 5) and not x.is_contiguous():
        fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
        if x.is_contiguous(memory_format=fmt):
            return t.contiguous(memory_format=fmt)
    return t.contiguous()


def _exchange(scope: SpatialScope, sends, recvs, device, dtype):
    """Point-to-point within the spatial group: `sends` lists (spatial
    index, tensor), `recvs` (spatial index, shape); returns the received
    tensors on `device`. All operations are posted at once and waited on
    together, so that no order of the ranks can deadlock."""
    via_host = device.type == "cuda" and communication.backend() == "gloo"
    ops, out = [], []
    for peer, t in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, mesh.to_host(t) if via_host else t,
                              scope.ranks[peer], scope.group))
    for peer, shape in recvs:
        buf = torch.empty(shape, dtype=dtype, pin_memory=via_host,
                          device="cpu" if via_host else device)
        out.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, scope.ranks[peer], scope.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(device) for b in out] if via_host else out


def _halo_forward(x, lo, hi, dim, scope):
    size = x.shape[dim]
    if lo > size or hi > size:
        raise ValueError(f"a halo of ({lo}, {hi}) rows exceeds the shard's {size} rows along "
                         f"dim {dim}: the halo exchange reaches only the neighbours")
    shape = list(x.shape)
    sends, recvs, where = [], [], []
    if lo and not scope.last:
        sends.append((scope.index + 1, x.narrow(dim, size - lo, lo)))
    if hi and not scope.first:
        sends.append((scope.index - 1, x.narrow(dim, 0, hi)))
    if lo and not scope.first:
        recvs.append((scope.index - 1, shape[:dim] + [lo] + shape[dim + 1:]))
        where.append("lo")
    if hi and not scope.last:
        recvs.append((scope.index + 1, shape[:dim] + [hi] + shape[dim + 1:]))
        where.append("hi")
    got = dict(zip(where, _exchange(scope, sends, recvs, x.device, x.dtype)))
    parts = []
    if lo:
        parts.append(got.get("lo", x.new_zeros(shape[:dim] + [lo] + shape[dim + 1:])))
    parts.append(x)
    if hi:
        parts.append(got.get("hi", x.new_zeros(shape[:dim] + [hi] + shape[dim + 1:])))
    return torch.cat([_like(p, x) for p in parts], dim) if len(parts) > 1 else x


def _halo_backward(g, lo, hi, dim, scope):
    size = g.shape[dim] - lo - hi
    shape = list(g.shape)
    sends, recvs, where = [], [], []
    if lo and not scope.first:
        sends.append((scope.index - 1, g.narrow(dim, 0, lo)))
    if hi and not scope.last:
        sends.append((scope.index + 1, g.narrow(dim, lo + size, hi)))
    if lo and not scope.last:
        recvs.append((scope.index + 1, shape[:dim] + [lo] + shape[dim + 1:]))
        where.append("lo")
    if hi and not scope.first:
        recvs.append((scope.index - 1, shape[:dim] + [hi] + shape[dim + 1:]))
        where.append("hi")
    got = dict(zip(where, _exchange(scope, sends, recvs, g.device, g.dtype)))
    dx = g.narrow(dim, lo, size).clone()
    if "lo" in got:     # the right neighbour's left halo: my last rows
        dx.narrow(dim, size - lo, lo).add_(got["lo"])
    if "hi" in got:     # the left neighbour's right halo: my first rows
        dx.narrow(dim, 0, hi).add_(got["hi"])
    return dx


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, lo, hi, dim, scope):
        ctx.lo, ctx.hi, ctx.dim, ctx.scope = lo, hi, dim, scope
        _count("halo", scope)
        with _timed("halo", x):
            return _halo_forward(x, lo, hi, dim, scope)

    @staticmethod
    def backward(ctx, g):
        _count("halo", ctx.scope)
        with _timed("halo", g):
            return _halo_backward(g, ctx.lo, ctx.hi, ctx.dim, ctx.scope), None, None, None, None


def halo_exchange(x: torch.Tensor, lo: int, hi: int, dim: int,
                  scope: Optional[SpatialScope] = None) -> torch.Tensor:
    """`x` with `lo` rows of the left neighbour's slab before it and `hi`
    of the right neighbour's after it along `dim`; the global edges get
    zeros. A negative `lo` or `hi` crops that many rows instead.
    Differentiable: the backward sends each halo's gradient back to the rank
    that owns those rows, which adds it into its edge rows."""
    scope = scope or active()
    if lo < 0:
        x, lo = x.narrow(dim, -lo, x.shape[dim] + lo), 0
    if hi < 0:
        x, hi = x.narrow(dim, 0, x.shape[dim] + hi), 0
    if lo == hi == 0:
        return x
    return _Halo.apply(x, lo, hi, dim, scope)


def _edge_rows(x, dim, n, side, mode):
    """The `n` rows that `mode` ('reflect', 'replicate'/'edge') pads on
    `side` ('lo' or 'hi') of `x` along `dim`."""
    size = x.shape[dim]
    if mode == "reflect":
        if n >= size:
            raise ValueError(f"reflect padding of {n} rows needs more than {n} rows in the "
                             f"edge shard, which holds {size} along dim {dim}")
        rows = x.narrow(dim, 1, n) if side == "lo" else x.narrow(dim, size - 1 - n, n)
        return rows.flip(dim)
    edge = x.narrow(dim, 0, 1) if side == "lo" else x.narrow(dim, size - 1, 1)
    return edge.expand(*x.shape[:dim], n, *x.shape[dim + 1:])


def pad_halo(x: torch.Tensor, lo: int, hi: int, dim: int, mode: str = "zeros",
             scope: Optional[SpatialScope] = None) -> torch.Tensor:
    """`halo_exchange`, with the global edges padded by `mode` ('zeros',
    'reflect', 'replicate', 'edge') instead of zeros."""
    scope = scope or active()
    h = halo_exchange(x, lo, hi, dim, scope)
    if mode == "zeros" or (lo <= 0 and hi <= 0):
        return h
    parts = []
    if lo > 0 and scope.first:
        parts.append(_edge_rows(x, dim, lo, "lo", mode))
        h = h.narrow(dim, lo, h.shape[dim] - lo)
    parts.append(h)
    if hi > 0 and scope.last:
        parts[-1] = h.narrow(dim, 0, h.shape[dim] - hi)
        parts.append(_edge_rows(x, dim, hi, "hi", mode))
    return torch.cat([_like(p, x) for p in parts], dim) if len(parts) > 1 else h


# ------------------------------------------------------------------- gather


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, scope, site):
        ctx.dim, ctx.scope, ctx.size = dim, scope, x.shape[dim]
        _count("gather", scope, site)
        with _timed("collective", x):
            parts = mesh.all_gather(x, scope.group, scope.size)
            return torch.cat([_like(p, x) for p in parts], dim)

    @staticmethod
    def backward(ctx, g):
        # Every rank's loss took a part of the replicated tensor: the sum of
        # their gradients, this rank's slab of it.
        g = ctx.scope.all_reduce(g.clone(memory_format=torch.contiguous_format))
        return g.narrow(ctx.dim, ctx.scope.index * ctx.size, ctx.size), None, None, None


def gather(x: torch.Tensor, dim: int, scope: Optional[SpatialScope] = None,
           site: Optional[str] = None) -> torch.Tensor:
    """The whole tensor from the equal slabs of the spatial group along
    `dim`, on every rank; `site` names a declared replicated section
    (`SITES`). Differentiable: the backward sums the ranks' gradients and
    keeps this rank's slab, so a replicated section after it must end in a
    share of a loss (`global_mean`) or in `slab`."""
    scope = scope or active()
    return _Gather.apply(x, dim, scope, site)


def slab(x: torch.Tensor, dim: int, scope: Optional[SpatialScope] = None) -> torch.Tensor:
    """This rank's equal slab along `dim` of a tensor that every rank of the
    group holds whole (a replicated section's result): the end of a
    replicated section that returns to slabs. Its backward keeps this
    rank's rows and zeros elsewhere, so that the ranks' gradients of the
    whole tensor, and of the parameters before it, sum to the whole
    gradient."""
    scope = scope or active()
    if x.shape[dim] % scope.size:
        uneven("slab", x.shape[dim], scope)
    return mesh.spatial_slab(x, dim, scope.index, scope.size)


# ------------------------------------------------------------------ re-slab


def _overlap(owner: int, owned: int, wanter: int, start: int, wanted: int):
    """Global rows `[lo, hi)` that rank `owner` holds (its slab of `owned`
    rows) and rank `wanter` wants (`wanted` rows from `start + wanter *
    wanted`), or None."""
    lo = max(owner * owned, start + wanter * wanted)
    hi = min((owner + 1) * owned, start + (wanter + 1) * wanted)
    return (lo, hi) if lo < hi else None


def _shape(x, dim, rows):
    return x.shape[:dim] + (rows,) + x.shape[dim + 1:]


class _Reslab(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, start, length, scope, site):
        ctx.dim, ctx.start, ctx.scope, ctx.owned = dim, start, scope, x.shape[dim]
        ctx.wanted, ctx.site = length // scope.size, site
        _count("reslab", scope, site)
        with _timed("collective", x):
            return _reslab(x, dim, start, x.shape[dim], ctx.wanted, scope, forward=True)

    @staticmethod
    def backward(ctx, g):
        _count("reslab", ctx.scope, ctx.site)
        with _timed("collective", g):
            dx = _reslab(g, ctx.dim, ctx.start, ctx.owned, ctx.wanted, ctx.scope,
                         forward=False)
        return dx, None, None, None, None, None


def _reslab(t, dim, start, owned, wanted, scope, forward):
    """The forward moves each overlap of an owner's slab and a wanter's rows
    from owner to wanter; the backward moves the gradients of the same
    overlaps back, into a zero gradient of the owner's slab."""
    me, n = scope.index, scope.size
    sends, recvs, places = [], [], []
    for peer in range(n):
        if peer == me:
            continue
        out = _overlap(me, owned, peer, start, wanted) if forward \
            else _overlap(peer, owned, me, start, wanted)
        if out is not None:
            base = me * owned if forward else start + me * wanted
            sends.append((peer, t.narrow(dim, out[0] - base, out[1] - out[0])))
        into = _overlap(peer, owned, me, start, wanted) if forward \
            else _overlap(me, owned, peer, start, wanted)
        if into is not None:
            recvs.append((peer, _shape(t, dim, into[1] - into[0])))
            places.append(into)
    got = _exchange(scope, sends, recvs, t.device, t.dtype)
    local = _overlap(me, owned, me, start, wanted)
    if forward:
        parts = list(zip(places, got))
        if local is not None:
            parts.append((local, t.narrow(dim, local[0] - me * owned, local[1] - local[0])))
        parts.sort(key=lambda p: p[0][0])
        return torch.cat([_like(p, t) for _, p in parts], dim) if len(parts) > 1 \
            else parts[0][1].clone()
    dx = t.new_zeros(_shape(t, dim, owned))
    if local is not None:
        dx.narrow(dim, local[0] - me * owned, local[1] - local[0]).add_(
            t.narrow(dim, local[0] - (start + me * wanted), local[1] - local[0]))
    for (lo, hi), part in zip(places, got):
        dx.narrow(dim, lo - me * owned, hi - lo).add_(part)
    return _like(dx, t)


def reslab(x: torch.Tensor, dim: int, start: int, length: int,
           scope: Optional[SpatialScope] = None, site: Optional[str] = None) -> torch.Tensor:
    """Even slabs of the global rows `[start, start + length)` of a tensor
    sharded in equal slabs along `dim`: this rank's is rows `start + index *
    m` to `start + (index + 1) * m`, `m = length / size`, taken point to
    point from the ranks that hold them. Differentiable: the backward sends
    each row's gradient back to the rank that owns it. `length` must divide
    over the group."""
    scope = scope or active()
    if length % scope.size:
        uneven("reslab", length, scope)
    return _Reslab.apply(x, dim, start, length, scope, site)


# ------------------------------------------------------------ indexed select


class _Select(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rows, ids, scope, site):
        local, mine = _owned(rows.shape[1], ids, scope)
        ctx.scope, ctx.rows, ctx.dtype = scope, rows.shape[1], rows.dtype
        ctx.save_for_backward(local, mine)
        _count("select", scope, site)
        out = torch.where(mine[None, :, None], rows.index_select(1, local).float(), 0.0)
        return scope.all_reduce(out)

    @staticmethod
    def backward(ctx, g):
        local, mine = ctx.saved_tensors
        # Every rank's share of the replicated patches' loss: their sum is
        # the whole gradient, whose owned rows go into this rank's slab.
        g = ctx.scope.all_reduce(g.contiguous().clone())
        g = torch.where(mine[None, :, None], g, 0.0).to(ctx.dtype)
        dx = g.new_zeros((g.shape[0], ctx.rows, g.shape[2]))
        return dx.index_add_(1, local, g), None, None, None


def _owned(rows: int, ids: torch.Tensor, scope: SpatialScope):
    lo = scope.index * rows
    mine = (ids >= lo) & (ids < lo + rows)
    return (ids - lo).clamp(0, rows - 1), mine


def select(rows: torch.Tensor, ids: torch.Tensor, scope: Optional[SpatialScope] = None,
           site: Optional[str] = None) -> torch.Tensor:
    """Rows `ids` (global positions of the flattened sample, the same on
    every rank) of `rows` `(B, S, C)`, this rank's `S` flattened rows of a
    slab along the first spatial dim (global positions `index * S` on), as
    fp32 `(B, len(ids), C)` on every rank: each rank fills the rows it owns
    and the group sums them. Differentiable: the backward sums the ranks'
    gradients (shares of a replicated loss) and scatters each row's into
    the slab that owns it."""
    scope = scope or active()
    return _Select.apply(rows, ids, scope, site)


# ------------------------------------------------------------- conv helpers


def conv_halo(kernel: int, stride: int, padding: int, size: int) -> Optional[Tuple[int, int]]:
    """`(lo, hi)`: the rows a conv's window reaches beyond each side of an
    equal shard of `size` rows, when every shard's output is its own equal
    slab of the whole output (`size` divides by the stride, and the
    output extent is the input's over the stride); None otherwise."""
    if size % stride or (2 * padding - kernel) // stride != -1:
        return None
    return padding, kernel - stride - padding


def conv_transpose_halo(kernel: int, stride: int, padding: int,
                        output_padding: int) -> Optional[Tuple[int, int]]:
    """`(lo, hi)` input rows a transposed conv needs beyond each side of a
    shard, when every shard's output is its own equal slab of the whole
    output (out = in * stride); None otherwise."""
    if kernel + output_padding - 2 * padding != stride or kernel < stride:
        return None
    return (kernel - 1 - padding) // stride, (padding - 1) // stride + 1


def uneven(what: str, size: int, scope: SpatialScope, halo: Optional[Tuple[int, int]] = None):
    """Raise for layer `what`, whose input slab of `size` rows it cannot run
    on: its output would not split evenly, or (`halo`) its window reaches
    past the neighbours' slabs."""
    why = ("its output slabs would not line up with its input's" if halo is None else
           f"its window needs ({halo[0]}, {halo[1]}) rows of the neighbours', and the halo "
           f"exchange reaches only theirs")
    raise ValueError(
        f"{what} does not split evenly over {scope.size} spatial shards of {size} rows along "
        f"spatial dim {scope.spatial_dim}: {why}. Choose an extent that the convs keep "
        f"divisible, or fewer spatial ranks")


def sharded_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dim: int = 2, scope: Optional[SpatialScope] = None) -> torch.Tensor:
    """'SAME' zero-padded stride-1 conv of an `(N, C, *spatial)` tensor
    sharded along `dim`, with an odd `(O, I, *k)` kernel: exact against the
    unsharded conv (the JAX package's `sharded_conv`)."""
    scope = scope or active()
    k = weight.shape[2:]
    half = k[dim - 2] // 2
    xh = halo_exchange(x, half, half, dim, scope)
    padding = [kk // 2 for kk in k]
    padding[dim - 2] = 0
    conv = {4: torch.nn.functional.conv2d, 5: torch.nn.functional.conv3d}[x.dim()]
    return conv(xh, weight, bias, 1, padding)


# ------------------------------------------------------------------- losses


def global_mean(t: torch.Tensor, count: Optional[int] = None) -> torch.Tensor:
    """The mean of `t` over the whole sample, as this rank's share, so that
    the spatial ranks' shares sum to the mean: the local mean over the
    ranks, for an equal slab and for a tensor every rank holds whole (a
    replicated leaf, the PatchGAN's tail) alike; the local sum over `count`,
    the global count, where the slabs differ (the SSIM map's VALID region).
    The plain mean outside a scope."""
    scope = current()
    if scope is None:
        return t.mean()
    if count is None:
        return t.mean() / scope.size
    return t.sum() / count


def total(value: torch.Tensor) -> torch.Tensor:
    """The sum of a share (`global_mean`) over the spatial group, detached:
    the value of the whole sample, on every rank. The value itself outside
    a scope."""
    scope = current()
    if scope is None:
        return value
    return scope.all_reduce(value.detach().clone())


def total_dict(values: dict) -> dict:
    """`total` of every entry of a dict of scalar tensors, in one
    all-reduce."""
    scope = current()
    if scope is None or not values:
        return values
    keys = sorted(values)
    summed = scope.all_reduce(torch.stack([values[k].detach().float() for k in keys]))
    return {k: v.to(values[k].dtype) for k, v in zip(keys, summed.unbind())}


# ---------------------------------------------------------------- inference


def _check_shards(x, dim, scope, halo=None):
    n = scope.size
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} must divide across {n} devices")
    shard = x.shape[dim] // n
    if halo is not None and halo > shard:
        raise ValueError(f"halo {halo} exceeds the per-device shard size {shard} (dim {dim} of "
                         f"{x.shape[dim]} over {n} devices) — the halo exchange only reaches "
                         f"immediate neighbors")
    return shard


def spatially_sharded_infer(network_fn, x: torch.Tensor, halo: int, dim: int = 1,
                            scope: Optional[SpatialScope] = None) -> torch.Tensor:
    """Run `network_fn` on this rank's slab of `x` along `dim` plus `halo`
    rows of each neighbour's (zeros at the global edges), crop the halo
    rows off its output and gather the whole output on every rank. The
    network sees a whole tensor (per-shard norm statistics) and must keep
    the extent along `dim`. Every rank passes the same `x`."""
    scope = scope or make_scope(dim - 1)
    shard = _check_shards(x, dim, scope, halo)
    local = x.narrow(dim, scope.index * shard, shard)
    with torch.no_grad():
        y = network_fn(halo_exchange(local, halo, halo, dim, scope))
        return gather(y.narrow(dim, halo, shard), dim, scope)


def spatially_sharded_infer_gspmd(network_fn, x: torch.Tensor, dim: int = 1,
                                  scope: Optional[SpatialScope] = None) -> torch.Tensor:
    """The exact forward of `network_fn` on `x` split along `dim` over the
    spatial group: the network runs on this rank's slab inside
    `spatial_scope`, so its convs exchange halos and its norms take the
    whole volume's statistics, and the output is gathered on every rank.
    `dim` is of the channels-last `(N, *spatial, C)` input."""
    scope = scope or make_scope(dim - 1)
    shard = _check_shards(x, dim, scope)
    local = x.narrow(dim, scope.index * shard, shard)
    with torch.no_grad():
        with spatial_scope(scope):
            y = network_fn(local)
        return gather(y, dim, scope)

