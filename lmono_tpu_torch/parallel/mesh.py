"""The device mesh on `torch.distributed`: ranks, axes and collectives.

Port of `lmono_tpu/parallel/mesh.py` and of the mesh half of
`dist_engine.py` (`make_engine_mesh`).  The JAX package lays one program
over a `jax.sharding.Mesh` with `shard_map`; here the program is SPMD over
processes.  Every rank runs the same host code, holds its own block of
each sharded array as an ordinary tensor beside a replica of everything
else, and calls the same collectives in the same order as every other
rank.  Rank r of a (kf, map) mesh sits at (r // map, r % map), the JAX
mesh's row-major device layout.

An `Axis` (process group, size, this rank's index) is what `axis=` means
in the port, where the JAX package passes a mesh-axis name; `axis=None` is
the single-device path.  Its four collectives are all the JAX package
uses: `psum`, `all_gather`, `axis_index` and `axis_size`.  A size-1 axis
makes them identities, so one mesh shape covers every `ParallelConfig`.

Nothing here depends on the backend: on one card the ranks share it over
gloo, across cards NCCL carries the same calls.  The caller initializes
the process group (`init_process_group`); `Mesh` only builds the
per-axis subgroups, every rank all of them in the same order.
"""

from __future__ import annotations

import datetime
import itertools
import math

import torch
import torch.distributed as dist


class Axis:
    """One mesh axis as this rank sees it: the subgroup of ranks that differ
    from it only along the axis, its size and this rank's index on it."""

    def __init__(self, name: str, group, size: int, index: int):
        self.name = name
        self.group = group
        self.size = size
        self.index = index
        # collectives issued on this axis and the bytes this rank put into
        # them: {"psum" | "all_gather": [calls, bytes]}
        self.stats = {"psum": [0, 0], "all_gather": [0, 0]}

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.stats[kind][0] += 1
        self.stats[kind][1] += x.numel() * x.element_size()

    def axis_size(self) -> int:
        return self.size

    def axis_index(self) -> int:
        return self.index

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of `x` over the axis, the same bits on every rank.  Booleans
        are summed as int32 (the count of ranks where they are true)."""
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        if self.size == 1:
            return x
        y = x.clone(memory_format=torch.contiguous_format)
        self._count("psum", y)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every rank's `x` in axis order: stacked along a new `dim`, or
        concatenated along `dim` when `tiled` (`lax.all_gather`'s
        semantics)."""
        if self.size == 1:
            return x if tiled else x.unsqueeze(dim)
        src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        self._count("all_gather", src)
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        return out.to(torch.bool) if x.dtype == torch.bool else out


class Mesh:
    """A named mesh over every rank of the initialized process group.

    shape: {axis name: size} in row-major order; its product must be the
    world size.  Making the per-axis subgroups is a collective of the
    whole process group, so every rank makes all of them in one order.
    `mesh.axis("kf")` is this rank's `Axis` on it."""

    def __init__(self, shape: dict[str, int]):
        if not dist.is_initialized():
            raise RuntimeError(
                "a device mesh needs an initialized torch.distributed process "
                "group of one rank per mesh position (see "
                "lmono_tpu_torch.parallel.mesh.init_process_group and "
                "python -m lmono_tpu_torch.run_multihost)")
        n = math.prod(shape.values())
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"mesh {shape} needs {n} ranks, the process group "
                             f"has {world}")
        self.shape = dict(shape)
        self.rank = dist.get_rank()
        names, sizes = list(shape), list(shape.values())
        pos, coords = self.rank, []
        for sz in reversed(sizes):
            coords.append(pos % sz)
            pos //= sz
        self.coords = dict(zip(names, reversed(coords)))
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        self.axes = {}
        for a, name in enumerate(names):
            if sizes[a] in (1, world):
                # a size-1 axis needs no group; one spanning the world
                # uses the default group
                self.axes[name] = Axis(name, None, sizes[a], self.coords[name])
                continue
            # every rank makes every subgroup of this axis, in one order
            others = [range(sz) if i != a else range(1)
                      for i, sz in enumerate(sizes)]
            mine = None
            for base in itertools.product(*others):
                sub = [sum((base[i] if i != a else j) * strides[i]
                           for i in range(len(sizes)))
                       for j in range(sizes[a])]
                g = dist.new_group(sub)
                if self.rank in sub:
                    mine = g
            self.axes[name] = Axis(name, mine, sizes[a], self.coords[name])

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def collective_stats(self) -> dict:
        """{axis: {"psum" | "all_gather": [calls, bytes]}} so far; the
        bytes are what this rank put in."""
        return {n: {k: list(v) for k, v in a.stats.items()}
                for n, a in self.axes.items()}

    def reset_stats(self) -> None:
        for a in self.axes.values():
            a.stats = {"psum": [0, 0], "all_gather": [0, 0]}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(n_devices: int | None = None, axis: str = "kf") -> Mesh:
    """A 1-D mesh over all ranks (`n_devices`, when given, must be the
    world size)."""
    n = n_devices or dist.get_world_size()
    return Mesh({axis: n})


def make_mesh_2d(kf: int, map_: int) -> Mesh:
    return Mesh({"kf": kf, "map": map_})


def init_process_group(rank: int, world_size: int, init_method: str,
                       timeout_s: float = 300.0) -> None:
    """`torch.distributed.init_process_group` with gloo (which carries CPU
    and CUDA tensors, so several ranks can share one card) and a timeout,
    so a rank whose peers have died fails instead of hanging."""
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


# --------------------------------------------------------------------------
# Trees of tensors as one buffer of 32-bit words
# --------------------------------------------------------------------------

def pack_words(tensors: list, lead: int = 1) -> tuple[torch.Tensor, list]:
    """Tensors sharing their first `lead` dims → one int32 buffer
    (*lead dims, words) holding their bits (float32 and int64 viewed as
    int32, narrower integers and bool widened; another floating type
    raises), and the layout to undo it with
    `unpack_words`.  A gather moves the bits as they are, and a psum in
    which one rank contributes a row and the others zeros gives that row's
    bits exactly."""
    shape = tensors[0].shape[:lead]
    cols, layout = [], []
    for x in tensors:
        if x.dtype in (torch.float32, torch.int64):
            w = x.contiguous().view(torch.int32)
        elif x.is_floating_point() or x.is_complex():
            raise TypeError(f"pack_words carries float32 and integer tensors "
                            f"exactly, not {x.dtype}")
        else:
            w = x.to(torch.int32)
        cols.append(w.reshape(*shape, -1))
        layout.append((x.dtype, x.shape[lead:], cols[-1].shape[-1]))
    return torch.cat(cols, -1), layout


def unpack_words(buf: torch.Tensor, layout: list) -> list:
    """The tensors packed by `pack_words`, from a buffer whose leading dims
    may differ from the packed ones (a gathered buffer, for instance)."""
    shape, out, i = buf.shape[:-1], [], 0
    for dtype, tail, n in layout:
        w = buf[..., i:i + n]
        i += n
        if dtype in (torch.float32, torch.int64):
            x = w.contiguous().view(dtype)
        elif dtype == torch.bool:
            x = w != 0
        else:
            x = w.to(dtype)
        out.append(x.reshape(*shape, *tail))
    return out


def all_gather_rows(axis: Axis, tree):
    """A NamedTuple of tensors sharing their leading (row) dim, gathered
    over `axis` along it in one collective."""
    if axis.size == 1:
        return tree
    buf, layout = pack_words(list(tree))
    return type(tree)(*unpack_words(axis.all_gather(buf, 0, tiled=True), layout))


# --------------------------------------------------------------------------
# Spec trees: which leaves shard their leading dim over which axis
# --------------------------------------------------------------------------

def _is_leaf(x) -> bool:
    return not isinstance(x, (tuple, list, dict))


def map_spec(fn, specs, value):
    """fn(spec, leaf) over `value` under a spec tree.  A spec is an axis
    name (the leaf's leading dim is sharded over it) or None (replicated);
    a spec standing where `value` has a subtree covers the whole subtree,
    as a `PartitionSpec` prefix does."""
    if specs is None or isinstance(specs, str):
        return _map_leaves(lambda x: fn(specs, x), value)
    if isinstance(value, dict):
        return {k: map_spec(fn, specs[k], v) for k, v in value.items()}
    out = [map_spec(fn, s, v) for s, v in zip(specs, value)]
    return type(value)(*out) if hasattr(value, "_fields") else type(value)(out)


def _map_leaves(fn, value):
    if isinstance(value, dict):
        return {k: _map_leaves(fn, v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        out = [_map_leaves(fn, v) for v in value]
        return type(value)(*out) if hasattr(value, "_fields") else type(value)(out)
    return fn(value)


def _block(x, axis: Axis):
    """This rank's block of a global tensor's leading dim."""
    if not isinstance(x, torch.Tensor) or axis.size == 1:
        return x
    n = x.shape[0]
    if n % axis.size:
        raise ValueError(f"leading dim {n} does not split over axis "
                         f"{axis.name!r} of size {axis.size}")
    b = n // axis.size
    return x[axis.index * b:(axis.index + 1) * b].clone()


def shard_leading(mesh: Mesh, x, axis: str = "kf"):
    """This rank's block of every leaf's leading dim (the counterpart of
    placing a global array with `PartitionSpec(axis)`)."""
    ax = mesh.axis(axis)
    return _map_leaves(lambda v: _block(v, ax), x)


def replicated(mesh: Mesh, x, axis: str = "kf"):
    """The global value of leaves sharded over `axis`: every rank's block,
    gathered along the leading dim."""
    ax = mesh.axis(axis)
    return _map_leaves(
        lambda v: ax.all_gather(v, 0, tiled=True)
        if isinstance(v, torch.Tensor) else v, x)


def put_sharded(mesh: Mesh, value, specs):
    """This rank's part of a global tree under a spec tree: sharded leaves
    are cut to this rank's block, replicated ones kept whole."""
    return map_spec(lambda s, v: v if s is None else _block(v, mesh.axis(s)),
                    specs, value)


def gather_sharded(mesh: Mesh, value, specs):
    """The global tree from this rank's part (the inverse of
    `put_sharded`), the same on every rank."""
    return map_spec(
        lambda s, v: v if s is None or not isinstance(v, torch.Tensor)
        else mesh.axis(s).all_gather(v, 0, tiled=True), specs, value)
