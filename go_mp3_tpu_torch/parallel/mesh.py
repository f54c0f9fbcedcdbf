"""The stream mesh: many independent streams split over CUDA devices.

Counterpart of go_mp3_tpu/parallel/mesh.py. MP3 streams are independent,
so the multi-device strategy is the JAX package's: split the leading
stream axis S of a [S, T, ...] chunk into contiguous lane blocks, one per
mesh entry, and decode each block on its device with the chain kernel
(ops/kernels.decode_chunk). No data crosses devices: each block's input
goes from the host to its device, and each block's PCM stays there (or
goes to the host, copied by its own device).

A Mesh may name one device more than once. JAX cannot build such a mesh;
the port allows it only because torch has one CPU device and a one-card
machine one GPU, so a repeated entry is the only way to run the split in
the CPU tests and on one card. It is a way to check the split, not a way
to gain speed: the entries of one device share that device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.granule import DecodeState, GranuleBatch, init_state
from ..ops.kernels import decode_chunk

__all__ = [
    "STREAM_AXIS",
    "Mesh",
    "ShardedPCM",
    "ShardedState",
    "init_states",
    "make_mesh",
    "make_sharded_decoder",
    "make_sharded_packed_decoder",
]

STREAM_AXIS = "streams"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over `devices`, split along STREAM_AXIS."""

    devices: tuple[torch.device, ...]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (STREAM_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def blocks(self, n_streams: int) -> list[tuple[torch.device, int, int]]:
        """(device, lo, hi) of each entry's contiguous lane block [lo, hi);
        ValueError unless the mesh size divides n_streams."""
        if n_streams % self.size:
            raise ValueError(
                f"{n_streams} streams do not split evenly over a mesh of "
                f"{self.size} devices")
        n = n_streams // self.size
        return [(d, i * n, (i + 1) * n) for i, d in enumerate(self.devices)]

    def holds(self, device) -> bool:
        """Is `device` an entry of the mesh? (A bare "cuda" means the
        current CUDA device.)"""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = _index_device(resolve_device(dev))
        return dev in self.devices


def _index_device(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over every CUDA device, or over `devices` (torch.device,
    strings such as "cuda:1" or "cpu", or CUDA ordinals), which may repeat
    an entry (see the module's docstring). None raises where CUDA is
    unavailable: the mesh never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; make_mesh() spans every CUDA device. "
                "Pass devices=['cpu', ...] to split over the plain PyTorch "
                "chain on the CPU")
        devices = range(torch.cuda.device_count())
    devs = tuple(_index_device(resolve_device(d)) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def init_states(n_streams: int, device=None) -> DecodeState:
    """Zero DecodeStates of n_streams streams on `device` (None means
    CUDA). A sharded decoder takes them whole on its first call."""
    return init_state(n_streams, resolve_device(device))


class ShardedPCM(tuple):
    """The PCM of a sharded decode: one int16 [S/n, T*576, 2] block per
    mesh entry, each on its entry's device, in lane order. cpu() gathers
    them on the host (each block copied by its own device) into the
    unsharded decode's [S, T*576, 2]."""

    def cpu(self) -> torch.Tensor:
        return torch.cat([b.cpu() for b in self])


class ShardedState(tuple):
    """The DecodeStates of a sharded decode, one per mesh entry on its
    device; the sharded decoder takes them back on the next call. cpu()
    gathers them into one DecodeState of S streams on the host."""

    def cpu(self) -> DecodeState:
        return DecodeState(*(torch.cat([getattr(s, f).cpu() for s in self])
                             for f in DecodeState._fields))


def _split_states(states, blocks) -> list[DecodeState]:
    if isinstance(states, DecodeState):  # S streams, e.g. init_states(S)
        if states.store.shape[0] != blocks[-1][2]:
            raise ValueError(f"state of {states.store.shape[0]} streams, "
                             f"batch of {blocks[-1][2]}")
        return [DecodeState(states.store[lo:hi], states.v_fifo[lo:hi])
                for _, lo, hi in blocks]
    if len(states) != len(blocks):
        raise ValueError(f"{len(states)} shard states for a mesh of {len(blocks)}")
    return list(states)


def _decode_sharded(mesh: Mesh, streams, arrays, as_input, states, valid):
    """Shard d decodes lanes [lo, hi) of `arrays` (each [S, ...]) on its
    device: as_input(its slices) -> decode_chunk. On a CUDA entry the work
    runs on the entry's own stream, ordered after the caller's current
    stream and before it again, so the caller may use the results on its
    stream at once."""
    blocks = mesh.blocks(arrays[0].shape[0])
    if not isinstance(valid, torch.Tensor):
        valid = torch.from_numpy(np.asarray(valid, np.int32))
    shard_states = _split_states(states, blocks)
    pcm, out = [], []
    for (dev, lo, hi), stream, st in zip(blocks, streams, shard_states):
        def run():
            x = as_input([a[lo:hi].to(dev, non_blocking=True).contiguous()
                          for a in arrays])
            s = DecodeState(*(f.to(dev).contiguous() for f in st))
            return decode_chunk(x, s, valid[lo:hi].to(dev).contiguous())

        if stream is None:
            p, new = run()
        else:
            caller = torch.cuda.current_stream(dev)
            stream.wait_stream(caller)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                p, new = run()
            caller.wait_stream(stream)
            for t in (p, *new):  # freed only once the caller's stream is done
                t.record_stream(caller)
        pcm.append(p)
        out.append(new)
    return ShardedPCM(pcm), ShardedState(out)


def _entry_streams(mesh: Mesh) -> list:
    return [torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in mesh.devices]


def make_sharded_decoder(mesh: Mesh):
    """A [S, T, ...] GranuleBatch decoder with S split over the mesh
    (go_mp3_tpu/parallel/mesh.py:35-55).

    Returns decode(batch, states, valid) -> (pcm, states): batch a
    GranuleBatch [S, T, ...] (best on the host: each entry copies its
    block), states a DecodeState of S streams (the first call) or the
    ShardedState a previous call returned, valid int32 [S]. pcm is a
    ShardedPCM (pcm.cpu() gives the int16 [S, T*576, 2] of the unsharded
    decode); ValueError unless the mesh size divides S. `decode.mesh` is
    the mesh."""
    streams = _entry_streams(mesh)

    def decode(batch: GranuleBatch, states, valid):
        return _decode_sharded(mesh, streams, list(batch),
                               lambda xs: GranuleBatch(*xs), states, valid)

    decode.mesh = mesh
    return decode


def make_sharded_packed_decoder(mesh: Mesh):
    """Like make_sharded_decoder, over the packed two-array host interface
    (go_mp3_tpu/parallel/mesh.py:58-77): decode(spectra i16 [S,T,1152],
    side i16 [S,T,144], states, valid)."""
    streams = _entry_streams(mesh)

    def decode(spectra, side, states, valid):
        return _decode_sharded(mesh, streams, (spectra, side), tuple, states, valid)

    decode.mesh = mesh
    return decode
