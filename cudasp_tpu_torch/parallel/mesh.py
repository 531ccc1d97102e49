"""Device mesh and lane layout for data-parallel scanning (counterpart of
cudasp_tpu/parallel/mesh.py).

The workload is row-parallel: the mesh has one axis, DATA_AXIS, and each
of its entries scans a contiguous shard of a batch's lanes, while the
per-query operands (spend key, labels, comb table) are replicated, one
copy per distinct device. The JAX package runs one shard_map program over
the mesh; here the host fans out one launch per entry, each on that
entry's own stream (ops.kernels.scan_flags_sharded).

An entry is a torch.device, and a device may appear more than once: each
occurrence is a shard of its own, with its own streams and staging. That
is the counterpart of the JAX tests' forced host device count
(--xla_force_host_platform_device_count=8): `make_mesh(devices=["cpu"] *
8)` gives the CPU tests an 8-way mesh of the kernel's plain version, and
`make_mesh(devices=["cuda:0"] * 4)` splits every batch four ways on one
card."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

DATA_AXIS = "data"


class Mesh:
    """A one-axis mesh: its entries, in lane order. Meshes with the same
    entries are equal and hash alike; each object keeps its own per-entry
    CUDA streams (`streams`)."""

    axis_names = (DATA_AXIS,)

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's entries must all be 'cuda' or all "
                             f"'cpu' devices, got {devs}")
        self.devices = tuple(devs)
        self._streams = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in order of first entry."""
        return tuple(dict.fromkeys(self.devices))

    def streams(self) -> List[torch.cuda.Stream]:
        """One CUDA stream per entry, made at first use."""
        if self._streams is None:
            self._streams = [torch.cuda.Stream(d) for d in self.devices]
        return self._streams

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over every visible CUDA device, or the first n_devices of
    them, or over an explicit list `devices` in which a device may repeat
    (module docstring). With no CUDA device and no explicit list it
    raises: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass "
                "devices=['cpu'] * n for a mesh of the kernel's plain "
                "version on the CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = list(Mesh(devices).devices)
        if devs[0].type == "cuda":
            have = (torch.cuda.device_count()
                    if torch.cuda.is_available() else 0)
            if any(d.index >= have for d in devs):
                raise ValueError(f"mesh entries {[str(d) for d in devs]}: "
                                 f"{have} CUDA devices are visible")
    if n_devices is not None:
        if not 0 < n_devices <= len(devs):
            raise ValueError(f"requested {n_devices} devices, have "
                             f"{len(devs)}")
        devs = devs[:n_devices]
    return Mesh(devs)


def lane_ranges(size: int, width: int) -> List[tuple]:
    """The contiguous lane range (start, stop) of each of `size` entries
    in a batch `width` lanes wide (a multiple of `size`)."""
    per = width // size
    return [(k * per, (k + 1) * per) for k in range(size)]


class BatchShardings:
    """How a batch's tensors lie over a mesh: lane-sharded planes, one
    contiguous shard per entry on that entry's device, and replicated
    query tensors, one copy per distinct device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def lanes(self, x) -> list:
        """Per-entry lane shards of a (K, B) plane or a (B,) vector (the
        last axis splits), each contiguous on its entry's device. A list
        is taken to be sharded already and is returned as it is."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.mesh.size:
                raise ValueError(f"{len(x)} shards for a mesh of "
                                 f"{self.mesh.size}")
            return list(x)
        return [x[..., a:z].contiguous().to(d) for d, (a, z) in zip(
            self.mesh.devices, lane_ranges(self.mesh.size, x.shape[-1]))]

    def replicated(self, x) -> dict:
        """{device: copy of x on it} for each distinct device; a dict is
        taken to be replicated already."""
        if isinstance(x, dict):
            return x
        return {d: x.to(d) for d in self.mesh.distinct}


def is_sharded(x) -> bool:
    return isinstance(x, (list, tuple))


def gather_lanes(parts, device) -> torch.Tensor:
    """Per-entry shards back into one tensor on `device`, in lane order."""
    return torch.cat([p.to(device) for p in parts], dim=-1)


class Fanout:
    """The streams of one fan-out over a mesh's entries. On a CUDA mesh
    each entry's work runs on its stream: the caller's (`streams`), which
    the caller orders, or the mesh's own, which wait for each device's
    current stream here and are waited for by it in `join`. On the CPU
    there are no streams."""

    def __init__(self, mesh: Mesh, streams=None):
        self.mesh = mesh
        cuda = mesh.device_type == "cuda"
        self.own = cuda and streams is None
        if not cuda:
            self.streams = [None] * mesh.size
        elif streams is None:
            self.streams = mesh.streams()
            for s, d in zip(self.streams, mesh.devices):
                s.wait_stream(torch.cuda.current_stream(d))
        else:
            self.streams = list(streams)
            if len(self.streams) != mesh.size:
                raise ValueError(f"{len(self.streams)} streams for a mesh "
                                 f"of {mesh.size}")

    def on(self, k):
        """Context in which entry k's work is issued."""
        s = self.streams[k]
        return (contextlib.nullcontext() if s is None
                else torch.cuda.stream(s))

    def join(self, outputs):
        """outputs[k]: tensors that entry k made. With the mesh's own
        streams, each device's current stream waits for the entries on it
        and the tensors are marked as used there."""
        if not self.own:
            return
        for s, d, outs in zip(self.streams, self.mesh.devices, outputs):
            cur = torch.cuda.current_stream(d)
            cur.wait_stream(s)
            for t in outs:
                t.record_stream(cur)
