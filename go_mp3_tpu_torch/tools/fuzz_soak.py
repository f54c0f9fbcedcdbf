"""Fuzz soak of the port's C++ parser (tools/fuzz_soak.py's counterpart):
the int8 interface against the int16 parse on mutated streams.

    python -m go_mp3_tpu_torch.tools.fuzz_soak [n_mutants_per_fixture=200] [seed0=0]

Each fixture, cut to its first 60 kB (conformance/synthetic_escape.mp3
x128 and conformance/synthetic_lowrate.mp3 x110), is mutated by 1-60 bit
flips per mutant. On every mutant the int8 interface (int8 tail, head
plane, byte sidecar: the one the corpus path ships, parse_packed8_into)
is held against the int16 parse (parse_all): the spectra rebuilt from it
must be identical wherever no int8 overflow fired, the sidecar's
scalefactors must equal the int16 parse's, OverflowError may fire only
where an int16 tail value really leaves the int8 range, and the two
interfaces must agree on whether the stream is malformed. The parser runs
on the host only. Exits non-zero on the first mismatch.
"""

from __future__ import annotations

import random
import sys

import numpy as np

from ..consts import HEAD_LINES, HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH
from ..native import lib as native
from .corpus import ESCAPE, LOWRATE

CUT = 60_000  # bytes of each fixture


class Mismatch(Exception):
    """The two interfaces disagree on a mutant."""


def fixtures() -> dict[str, bytes]:
    return {"escape": (ESCAPE.read_bytes() * 128)[:CUT],
            "lowrate": (LOWRATE.read_bytes() * 110)[:CUT]}


def packed8_all(data: bytes):
    """Parse a whole stream through the int8 interface -> (spectra int16
    [n, 2, 576], side8 [n, SIDE8_WIDTH]); None on an int8 overflow;
    "error" on a malformed stream."""
    p = native.NativeParser(data)
    sp8 = np.zeros((8192, SP8_TAIL_WIDTH), np.int8)
    hd = np.zeros((8192, HEAD_WIDTH), np.int16)
    sd = np.zeros((8192, SIDE8_WIDTH), np.uint8)
    got = 0
    try:
        while k := p.parse_packed8_into(sp8[got:], hd[got:], sd[got:]):
            got += k
    except OverflowError:
        return None
    except ValueError:
        return "error"
    finally:
        p.close()
    head = hd[:got].reshape(got, 2, HEAD_LINES)
    tail = sp8[:got].reshape(got, 2, 576 - HEAD_LINES).astype(np.int16)
    return np.concatenate([head, tail], axis=2), sd[:got]


def check_mutant(m: bytes) -> str:
    """-> "checked", "overflowed" or "errored" (both parsers refused it);
    raises Mismatch on a mismatch."""
    p = native.NativeParser(m)
    try:
        sp16, sfl, _, _ = p.parse_all()
    except ValueError:
        r = packed8_all(m)
        if r is not None and not isinstance(r, str):
            raise Mismatch("int16 errored, packed8 did not")
        return "errored"
    finally:
        p.close()
    r = packed8_all(m)
    if isinstance(r, str):
        raise Mismatch("packed8 errored, int16 did not")
    n = sp16.shape[0]
    ref = sp16.reshape(n, 2, 576)
    if r is None:
        # the overflow must be justified: a tail line of the int16 parse
        # leaves the int8 range
        tail_ref = ref[:, :, HEAD_LINES:]
        if not ((tail_ref > 127) | (tail_ref < -128)).any():
            raise Mismatch("overflow fired with no out-of-range tail line")
        return "overflowed"
    spec8, sd = r
    if spec8.shape[0] != n:
        raise Mismatch(f"granule count {spec8.shape[0]} vs int16 {n}")
    if not np.array_equal(spec8, ref):
        bad = np.argwhere(spec8 != ref)[:3]
        raise Mismatch(f"spectra mismatch at {bad.tolist()}")
    # the sidecar's scalefactors equal the int16 parse's
    if not np.array_equal(sd[:, 44:88].astype(np.int8).astype(np.int32), sfl.reshape(n, 44)):
        raise Mismatch("scalefac_l mismatch")
    return "checked"


def soak(n_mut: int = 200, seed0: int = 0) -> dict:
    """n_mut mutants of each fixture -> counts of each outcome; raises
    Mismatch, naming the mutant, on the first mismatch."""
    counts = {"checked": 0, "overflowed": 0, "errored": 0}
    for fi, (fname, base) in enumerate(fixtures().items()):
        for i in range(n_mut):
            rng = random.Random(seed0 + i * 7919 + 1000 * fi)
            m = bytearray(base)
            for _ in range(rng.randint(1, 60)):
                pos = rng.randrange(len(m))
                m[pos] ^= 1 << rng.randrange(8)
            try:
                counts[check_mutant(bytes(m))] += 1
            except Mismatch as e:
                raise Mismatch(f"{fname}#{i}: {e}") from None
    return counts


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_mut = int(argv[0]) if argv else 200
    seed0 = int(argv[1]) if len(argv) > 1 else 0
    try:
        c = soak(n_mut, seed0)
    except Mismatch as e:
        print(f"FAIL {e}")
        return 1
    print(f"OK: {c['checked']} parity-checked, {c['overflowed']} overflow-fallbacks "
          f"(all justified), {c['errored']} hard-errors (both parsers agree)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
