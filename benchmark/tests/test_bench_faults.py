"""The output check fails what it must: the control (the reference in TF32 in
the program's place) and runs whose timed path is broken underneath, driven
through the rest of a run on the CPU."""

import numpy as np
import pytest

from benchmark import control

from cell_sizes import SIZES, run_cell


def _state_unchanged(orig):
    def chain(packed, state, valid, *a, **kw):
        pcm, _ = orig(packed, state, valid, *a, **kw)
        return pcm, state
    return chain


def _altered(orig):
    def chain(packed, state, valid, *a, **kw):
        pcm, new = orig(packed, state, valid, *a, **kw)
        pcm[:, 0, 0] += 100  # one sample of each stream's chunk
        return pcm, new
    return chain


def _half_batch(orig):
    """decode_corpus_fast that decodes the first half of the clips and gives
    nothing for the rest."""
    def decode(streams, *a, fetch=True, **kw):
        half = len(streams) // 2
        res = orig(streams[:half], *a, fetch=fetch, **kw)
        if fetch:
            res.pcm += [b""] * (len(streams) - half)
            return res
        import torch

        from go_mp3_tpu_torch.parallel.corpus import DeviceCorpus

        pcm, valids = res
        pad = torch.zeros((pcm.shape[0], len(streams) - half) + pcm.shape[2:],
                          dtype=pcm.dtype, device=pcm.device)
        v = np.zeros((valids.shape[0], len(streams) - half), valids.dtype)
        return DeviceCorpus(torch.cat([pcm, pad], 1), np.concatenate([valids, v], 1),
                            res.stats)
    return decode


def _half_lanes_silent(orig):
    """decode_corpus_fast whose second half of the batch comes back silent,
    at the right length: lanes left out that no length check sees."""
    def decode(streams, *a, fetch=True, **kw):
        res = orig(streams, *a, fetch=fetch, **kw)
        half = len(streams) // 2
        if fetch:
            res.pcm[half:] = [bytes(len(p)) for p in res.pcm[half:]]
        else:
            res[0][:, half:] = 0
        return res
    return decode


FAULTS = {"state_unchanged": ("go_mp3_tpu_torch.ops.kernels", "chain", _state_unchanged),
          "answer_altered": ("go_mp3_tpu_torch.ops.kernels", "chain", _altered),
          "half_batch": ("go_mp3_tpu_torch.parallel", "decode_corpus_fast", _half_batch)}
CASES = [(cell, fault) for cell in ("fma.fetch", "fma.ondevice", "player.seek", "player.read")
         for fault in FAULTS if fault != "half_batch" or cell.startswith("fma")]


@pytest.mark.parametrize("cell", ["fma.fetch", "fma.ondevice", "player.seek", "player.read"])
def test_sound_run_is_correct(cell):
    out = run_cell(cell)
    assert out["correct"], out["compared"].numbers()


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    mod_name, attr, wrap = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    out = run_cell(cell)
    assert not out["correct"], out["compared"].numbers()


@pytest.mark.parametrize("cell", ["fma.fetch", "player.seek", "player.read"])
def test_control_is_not_correct(cell):
    cfg, wl = control.load(cell)
    for key, value in {**SIZES[cfg["name"]], "clip_seconds": 3}.items():
        (cfg if key in cfg else wl)[key] = value
    c = control.control(cfg, wl, 2 ** 33 + 5)
    n = c.numbers()
    assert not c.ok()
    assert n["max_abs_lsb"]["value"] > 3 * n["max_abs_lsb"]["limit"]
    assert n["rms_lsb"]["value"] > 3 * n["rms_lsb"]["limit"]


@pytest.mark.parametrize("cell", ["fma.fetch", "fma.ondevice"])
def test_silent_lanes_are_not_correct(cell, monkeypatch):
    """Half of a batch of 8 left silent at the right length: every run is
    caught by the spans of every clip of the call drawn alone (no clip
    compared whole here)."""
    from go_mp3_tpu_torch import parallel

    monkeypatch.setattr(parallel, "decode_corpus_fast",
                        _half_lanes_silent(parallel.decode_corpus_fast))
    sizes = {"catalogue_clips": 8, "batch_clips": 8, "clip_seconds": 2, "check_clips": 0}
    for seed in (2 ** 31 + 7, 2 ** 33 + 1):
        out = run_cell(cell, seed=seed, sizes=sizes)
        n = out["compared"].numbers()
        assert not out["correct"], n
        assert n["length_mismatches"]["value"] == 0
        assert n["max_abs_lsb"]["value"] > 100 * n["max_abs_lsb"]["limit"]
