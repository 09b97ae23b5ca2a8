"""Sharding rules on a ``DeviceMesh``: the port of ``repro.parallel.sharding``.

``repro`` maps its LM stack onto a TPU mesh through GSPMD: parameters and
activations carry ``PartitionSpec``s and XLA inserts the collectives.  The
port does the same with ``torch.distributed.tensor`` (DTensor): a spec
becomes DTensor placements on a ``DeviceMesh`` whose ``mesh_dim_names`` are
``repro``'s axis names, and DTensor's sharding propagation inserts the
collectives.

* params: Megatron tensor parallelism over "model" (column-parallel QKV /
  gate-up, row-parallel out / down, vocab-parallel embedding and logits;
  MoE experts shard their hidden dim) plus fully sharded parameters over
  the data axes ("pod", "data"); ``models.api.param_sharding_rules``.
* activations: the batch over ("pod", "data"); ``shard(x, *spec)`` at
  ``repro``'s sites redistributes a DTensor to the spec's placements.

A spec is a tuple of entries, one a tensor dim: None (replicated), an axis
name, or a tuple of names, which shards one dim over several mesh dims,
major first, as JAX does.  ``_filter_spec`` drops the axes the mesh lacks
and the entries that do not divide the dim (DTensor allows uneven shards,
but the bytes a device holds are kept ``repro``'s).

Without an active mesh ``shard`` is the identity and ``local_region`` runs
its function on the tensors as they are, so the single-device path is the
one it always was.  Nothing here opens a process group: the caller builds
the mesh (``launch.mesh.make_production_mesh``, or
``torch.distributed.device_mesh.init_device_mesh`` over a group it
opened) and enters ``use_mesh``.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = [
    "DATA_AXES", "PartitionSpec", "P", "NamedSharding", "use_mesh", "active_mesh", "axis_ways",
    "dp_only_mode", "dp_only_active", "shard", "batch_spec", "place_batch", "named_sharding",
    "placements", "distribute", "is_dtensor", "local_region", "write_slice", "split_last",
    "gather_last", "fsdp_gather", "full", "per_shard",
    "full_tensor", "spec_of",
]

_ACTIVE: list = []
_DP_ONLY: list[bool] = []
DATA_AXES = ("pod", "data")  # folded batch axes (pod may be absent)


def _canonical(entry):
    """A spec entry as JAX keeps it: a one-name tuple is the name, an empty
    one None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: a tuple of entries,
    kept in JAX's canonical form."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with
    ``axis_names`` and a ``shape`` mapping, as a JAX ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


@contextmanager
def dp_only_mode():
    """ZeRO-3 axis remapping: the "model" axis joins data parallelism,
    batch shards over ("data", "model"), tensor-parallel entries are
    dropped.  Constraints written for the TP layout are translated on the
    fly."""
    _DP_ONLY.append(True)
    try:
        yield
    finally:
        _DP_ONLY.pop()


def dp_only_active() -> bool:
    return bool(_DP_ONLY)


def _translate_dp_only(spec) -> PartitionSpec:
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            if tuple(entry) == DATA_AXES:
                out.append(("data", "model"))  # batch over both in-pod axes
            else:
                out.append(tuple(a for a in entry if a != "model") or None)
        else:
            out.append(None if entry == "model" else entry)
    return P(*out)


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None for no mesh) the active one.
    Inside it plain tensors (RoPE tables, masks, ``torch.arange``) count as
    replicated where they meet DTensors."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _ACTIVE.append(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


def axis_ways(entry) -> int:
    """How many ways a spec entry (an axis name or a tuple of names) splits
    a dim on the active mesh (after ``dp_only_mode``'s translation): the
    product of the sizes of its axes the mesh has; 1 without a mesh."""
    mesh = active_mesh()
    if mesh is None or entry is None:
        return 1
    if dp_only_active():
        entry = _translate_dp_only(P(entry))[0]
        if entry is None:
            return 1
    sizes = _axis_sizes(mesh)
    ways = 1
    for a in entry if isinstance(entry, (tuple, list)) else (entry,):
        ways *= sizes.get(a, 1)
    return ways


def _filter_spec(spec, mesh, shape: tuple | None = None) -> PartitionSpec:
    """Drop axis names the mesh does not have (e.g. "pod" on one pod) and
    entries that do not divide the dim, trying the first axis alone first
    (granite's vocab 49,155 on a 16-wide axis stays replicated)."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept = tuple(a for a in axes if a in sizes)
        if shape is not None and kept:
            size = 1
            for a in kept:
                size *= sizes[a]
            if i >= len(shape) or shape[i] % size != 0:
                # try the first axis alone before giving up
                kept = tuple(a for a in kept if shape[i] % sizes[a] == 0)[:1]
        if not kept:
            out.append(None)
        elif len(kept) == 1 and not isinstance(entry, (tuple, list)):
            out.append(kept[0])
        else:
            out.append(kept)
    return P(*out)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of a (filtered) spec on ``mesh``: mesh dim
    ``m`` shards the tensor dim whose entry names it, and replicates
    where none does.  A dim over several mesh dims is split major first,
    which is DTensor's order when the names follow the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r}: axes out of the mesh's order "
                             f"{tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A mesh and a spec: ``jax.sharding.NamedSharding``'s counterpart, with
    the DTensor ``placements`` the spec becomes on the mesh."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_sharding(mesh, *entries, shape: tuple | None = None) -> NamedSharding:
    return NamedSharding(mesh, _filter_spec(P(*entries), mesh, shape=shape))


def batch_spec(*rest) -> tuple:
    """(("pod", "data"), *rest): the batch dim over the folded data axes."""
    return (DATA_AXES, *rest)


def place_batch(x, mesh):
    """A batch tensor (whole, the same on every rank) split by
    ``batch_spec`` over ``mesh``; as it is without a mesh."""
    if mesh is None:
        return x
    spec = batch_spec(*([None] * (x.ndim - 1)))
    return distribute(x, mesh, named_sharding(mesh, *spec, shape=tuple(x.shape)).placements)


def _local_chunk(t, mesh, pls):
    """This rank's shard of ``t`` under ``pls``: each Shard splits its dim
    by ``torch.chunk``, mesh dims in order (major first)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for m, pl in enumerate(pls):
        if isinstance(pl, Shard):
            t = torch.chunk(t, mesh.size(m), dim=pl.dim)[coord[m]]
    return t


def distribute(t, mesh, pls, *, requires_grad: bool | None = None):
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    placements ``pls``: each rank keeps its own chunk, with no
    communication (``distribute_tensor`` would scatter from rank 0)."""
    from torch.distributed.tensor import DTensor

    local = _local_chunk(t.detach(), mesh, pls).contiguous()
    out = DTensor.from_local(local, mesh, pls, run_check=False, shape=t.shape,
                             stride=t.stride())
    rg = t.requires_grad if requires_grad is None else requires_grad
    return out.requires_grad_(rg) if rg else out


class _ConstrainGrad(torch.autograd.Function):
    """The identity, whose backward brings the gradient to ``placements``:
    the transpose of a sharding constraint is the same constraint on the
    cotangent, as in JAX.  Without it DTensor leaves a gradient Partial
    across a block and all-gathers the weights to multiply it."""

    @staticmethod
    def forward(ctx, x, pls):
        ctx.pls = pls
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.pls:
            g = g.redistribute(g.device_mesh, ctx.pls)
        return g, None


def shard(x, *spec_entries):
    """Constrain ``x``, and its gradient, to the spec's placements when a
    mesh is active (a redistribute of a DTensor, a local chunk of a plain
    tensor, which every rank holds whole); the identity otherwise."""
    mesh = active_mesh()
    if mesh is None:
        return x
    spec = P(*spec_entries)
    if dp_only_active():
        spec = _translate_dp_only(spec)
    pls = placements(_filter_spec(spec, mesh, shape=tuple(x.shape)), mesh)
    if not is_dtensor(x):
        x = distribute(x, mesh, pls)
    elif tuple(x.placements) != pls:
        x = x.redistribute(mesh, pls)
    if x.requires_grad and torch.is_grad_enabled():
        x = _ConstrainGrad.apply(x, pls)
    return x


def fsdp_gather(w):
    """A parameter as a layer uses it: under a mesh its shards over the
    data axes (the FSDP ones) gathered, its "model" (tensor-parallel)
    shards kept, every shard gathered under ``dp_only_mode``; the gradient
    goes back by a reduce-scatter.  The identity on a plain tensor."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    keep = () if dp_only_active() else ("model",)
    pls = tuple(pl if mesh.mesh_dim_names[m] in keep else Replicate()
                for m, pl in enumerate(w.placements))
    if all(pl == q or mesh.size(m) == 1 for m, (pl, q) in enumerate(zip(pls, w.placements))):
        return w  # nothing to gather: one rank on each axis that would move
    return w.redistribute(mesh, pls)


def full(shape, fill, spec, *, dtype, device):
    """``torch.full(shape, fill)``; under a mesh a DTensor placed by
    ``spec``, each rank making only its own shard (a plain tensor would be
    made whole on every rank first)."""
    mesh = active_mesh()
    if mesh is None:
        return torch.full(shape, fill, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor, Shard

    spec = P(*spec)
    if dp_only_active():
        spec = _translate_dp_only(spec)
    pls = placements(_filter_spec(spec, mesh, shape=tuple(shape)), mesh)
    local = list(shape)
    for m, pl in enumerate(pls):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(m)
    t = torch.full(local, fill, dtype=dtype, device=device)
    stride, step = [], 1
    for n in reversed(shape):  # contiguous
        stride.insert(0, step)
        step *= n
    return DTensor.from_local(t, mesh, pls, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def full_tensor(x):
    """The whole tensor of a DTensor on every rank (a plain tensor as it
    is)."""
    return x.full_tensor() if is_dtensor(x) else x


def local_region(fn, *args):
    """``fn(*args)`` on whole local tensors: under a mesh each DTensor
    argument is gathered (redistributed to replicated) and ``fn`` runs on
    its local tensor, its tensor results coming back as replicated
    DTensors.  The regions DTensor has no sharding strategy for (the MoE
    sort dispatch) run so, on every rank alike.  Without DTensor
    arguments ``fn`` runs on ``args`` as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a for a in args]
    out = fn(*local)

    def wrap(o):
        if isinstance(o, torch.Tensor) and not is_dtensor(o):
            return DTensor.from_local(o, mesh, rep, run_check=False)
        return o

    if isinstance(out, tuple):
        return tuple(wrap(o) for o in out)
    return wrap(out)


def split_last(x, *sizes):
    """``x.reshape(*x.shape[:-1], *sizes)``, the last dim split (a flat
    head dim into heads).  DTensor cannot cut a head count that its shards
    do not divide (12 heads on a 16-wide "model" axis, which GSPMD
    reshards): such a DTensor is gathered along its last dim first."""
    shape = (*x.shape[:-1], *sizes)
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = x.ndim - 1
        ways = 1
        for m, pl in enumerate(x.placements):
            if isinstance(pl, Shard) and pl.dim == last:
                ways *= x.device_mesh.size(m)
        if sizes[0] % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
                for pl in x.placements])
    return x.reshape(shape)


def gather_last(x, index):
    """``torch.gather(x, -1, index[..., None])[..., 0]``.  On a DTensor ``x``
    sharded along its last dim (vocab-parallel logits) each rank gathers
    the indices its shard holds, zeros elsewhere, and the result is the
    sum over those shards (a Partial placement): the same values, with
    nothing of ``x`` gathered."""
    if not is_dtensor(x):
        return torch.gather(x, -1, index[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    idx_pl = [pl if isinstance(pl, Shard) and pl.dim < last else Replicate()
              for pl in x.placements]
    out_pl = [Partial() if isinstance(pl, Shard) and pl.dim == last else q
              for pl, q in zip(x.placements, idx_pl)]
    if not is_dtensor(index):
        index = distribute(index, mesh, [Replicate()] * mesh.ndim)
    idx = index.redistribute(mesh, idx_pl).to_local()
    off, length = _dim_offset(x, last)
    mine = (idx >= off) & (idx < off + length)
    local = torch.gather(x.to_local(), -1, torch.where(mine, idx - off, 0)[..., None])[..., 0]
    local = torch.where(mine, local, 0)
    return DTensor.from_local(local, mesh, out_pl, run_check=False)


@contextmanager
def _no_mesh():
    """No active mesh inside (``shard`` and ``full`` act as without one)."""
    _ACTIVE.append(None)
    try:
        yield
    finally:
        _ACTIVE.pop()


def per_shard(fn, tensors, dims, out_dims):
    """``fn`` on each rank's local shards, for math that is independent
    along some dims (the batch and the heads of attention).
    ``tensors[0]`` decides the layout: its Shard(d) with d in ``dims[0]``
    carries to each tensor i as Shard(dims[i][d]) (Replicate where
    ``dims[i]`` lacks d), every other placement becomes Replicate; the
    outputs come back as DTensors placed by ``out_dims`` the same way.
    ``dims`` are {dim of tensors[0]: dim of tensor i} maps.  No DTensor
    einsum runs, whose flattening of two sharded dims some DTensor versions
    refuse.  Without DTensors ``fn(*tensors)``."""
    ref = tensors[0]
    if not is_dtensor(ref):
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = ref.device_mesh
    split = [isinstance(pl, Shard) and pl.dim in dims[0] for pl in ref.placements]

    def layout(dmap):
        return [Shard(dmap[pl.dim]) if cut and pl.dim in dmap else Replicate()
                for pl, cut in zip(ref.placements, split)]

    local = []
    for t, dmap in zip(tensors, dims):
        if not is_dtensor(t):
            t = distribute(t, mesh, [Replicate()] * mesh.ndim)
        pls = layout(dmap)
        # a tensor whole across a split of the others (the SSD scan's B and
        # C across heads) gets a partial gradient from each rank there
        grads = [Partial() if cut and isinstance(q, Replicate) else q
                 for q, cut in zip(pls, split)]
        local.append(t.redistribute(mesh, pls).to_local(grad_placements=grads))
    with _no_mesh():
        out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, layout(dmap), run_check=False)
                    for o, dmap in zip(outs, out_dims))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def _dim_offset(x, dim: int) -> tuple[int, int]:
    """(start, length) of this rank's local slice of DTensor ``x`` along
    ``dim`` (even chunks, which ``_filter_spec`` guarantees)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, length = 0, x.shape[dim]
    for m, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            length //= mesh.size(m)
            start += coord[m] * length
    return start, length


def write_slice(buf, update, dim: int, start: int):
    """``buf.narrow(dim, start, n).copy_(update)`` in place, n =
    ``update.shape[dim]`` (the KV-cache write).  On a DTensor ``buf``
    the update is brought to ``buf``'s placements except along ``dim``,
    which it holds whole, and each rank writes the part of
    [start, start + n) its shard of ``dim`` owns, in its local tensor."""
    n = update.shape[dim]
    if not is_dtensor(buf):
        buf.narrow(dim, start, n).copy_(update)
        return buf
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
                 for pl in buf.placements)
    if not is_dtensor(update):
        update = distribute(update, mesh, want)
    upd = update.redistribute(mesh, want).to_local()
    off, length = _dim_offset(buf, dim)
    lo, hi = max(start, off), min(start + n, off + length)
    if lo < hi:
        buf.to_local().narrow(dim, lo - off, hi - lo).copy_(
            upd.narrow(dim, lo - start, hi - lo))
    return buf


def spec_of(rules: dict, name: str):
    """The spec of the parameter ``name`` (dotted, as ``named_parameters``
    gives it) in a nested rules dict; a layer index selects nothing (the
    port's layers are a list, not a stacked axis)."""
    node = rules
    for part in name.split("."):
        if part.isdigit():
            continue
        node = node[part]
    return node
