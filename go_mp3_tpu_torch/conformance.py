"""The conformance bundle on the port (tools/conformance.py:71-210's checks).

    python -m go_mp3_tpu_torch.conformance [--device cuda|cpu]

For each file of conformance/REPORT.json (the two
conformance/synthetic_*.mp3, read from this checkout and required; the
external reference fixtures where their recorded path exists):
 - its SHA-256 must be REPORT.json's (the same input);
 - it is decoded by the exact backend (go_mp3_tpu's C++ DSP), the golden
   backend (the numpy float64 oracle) and the port's device backend on
   --device; the pairs device/golden, exact/golden and device/exact must
   be ISO/IEC 11172-4 fully compliant (RMS < 0.289 LSB, max difference
   <= 2 LSB);
 - each PCM SHA-256 is printed beside REPORT.json's. The exact and golden
   hashes are expected to match; the device hash is for information,
   since the JAX chain on the CPU and the port's chain may differ by 1 LSB.
Then every present file goes through decode_corpus_fast with REPORT.json's
corpus settings (chunk_t=64, tail_buckets=(464, 512), n_threads=2,
drain=6), unsharded and on a two-entry mesh of --device: both must be
byte-identical to the per-stream device decodes.

Writes nothing; exits 1 on any failure, printing each.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

from . import Decoder, decode_corpus_fast
from .parallel.mesh import make_mesh
from .reference import FULL_MAXDIFF, FULL_RMS, decode_exact, iso_metrics

BUNDLE = Path(__file__).resolve().parent.parent / "conformance"
PAIRS = (("device", "golden"), ("exact", "golden"), ("device", "exact"))
CORPUS_SETTINGS = {"chunk_t": 64, "tail_buckets": (464, 512), "n_threads": 2,
                   "drain": 6}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _bundle_files(report: dict) -> tuple[list[tuple[str, bytes]], list[str]]:
    """-> ((name, bytes) of each REPORT.json file to check, the names of
    bundle files that are missing). A file the report recorded inside a
    conformance/ directory is a bundle file: it is read from this
    checkout's BUNDLE only, and missing is a failure. Any other file is an
    external fixture outside every checkout: read from its recorded path
    where that exists, skipped otherwise."""
    out, missing = [], []
    for name, entry in report["files"].items():
        recorded = Path(entry["path"])
        if recorded.parent.name == "conformance":
            path = BUNDLE / recorded.name
            if not path.exists():
                missing.append(name)
                continue
        else:
            path = recorded
            if not path.exists():
                print(f"{name}: external fixture {path} absent, skipped")
                continue
        out.append((name, path.read_bytes()))
    return out, missing


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m go_mp3_tpu_torch.conformance",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the device backend runs (default cuda)")
    args = ap.parse_args(argv)
    report = json.loads((BUNDLE / "REPORT.json").read_text())
    failures: list[str] = []

    def fail(msg: str) -> None:
        failures.append(msg)
        print(f"FAIL: {msg}")

    files, missing = _bundle_files(report)
    for name in missing:
        fail(f"{name}: bundle file missing from {BUNDLE}")
    device_pcm = {}
    for name, data in files:
        entry = report["files"][name]
        if _sha(data) != entry["input_sha256"]:
            fail(f"{name}: input SHA-256 differs from REPORT.json's")
            continue
        pcms = {
            "exact": decode_exact(data),
            "golden": Decoder(data, backend="golden").read_all(),
            "device": Decoder(data, device=args.device).read_all(),
        }
        device_pcm[name] = pcms["device"]
        for backend, pcm in pcms.items():
            want = entry["backends"][backend]["pcm_sha256"]
            got = _sha(pcm)
            print(f"{name} {backend}: {len(pcm)} B, sha256 {got} "
                  f"({'matches' if got == want else 'differs from'} REPORT.json's"
                  f"{'' if got == want else ' ' + want})")
        for a, b in PAIRS:
            if len(pcms[a]) != len(pcms[b]):
                fail(f"{name}: {a} {len(pcms[a])} B vs {b} {len(pcms[b])} B")
                continue
            rms, mx = iso_metrics(pcms[a], pcms[b])
            full = rms < FULL_RMS and mx <= FULL_MAXDIFF
            print(f"{name} {a} vs {b}: RMS {rms:.6f} LSB, max {mx} LSB, "
                  f"{'full compliance' if full else 'NOT full compliance'}")
            if not full:
                fail(f"{name}: {a} vs {b} not fully compliant")

    names = list(device_pcm)
    streams = [data for name, data in files if name in device_pcm]
    if streams:
        meshes = (("unsharded", None),
                  ("mesh of 2", make_mesh([args.device, args.device])))
        for label, mesh in meshes:
            res = decode_corpus_fast(streams, mesh=mesh, device=args.device,
                                     **CORPUS_SETTINGS)
            same = [res.pcm[i] == device_pcm[n] for i, n in enumerate(names)]
            print(f"corpus {label} {CORPUS_SETTINGS}: {res.granules} granules "
                  f"over {len(streams)} streams; byte-identical to the "
                  f"per-stream device decodes: {all(same)}")
            for n, ok in zip(names, same):
                if not ok:
                    fail(f"corpus {label}: {n} differs from its device decode")
    if not files:
        fail("no bundle file found")
    print(f"conformance on {args.device}: "
          f"{'PASS' if not failures else f'{len(failures)} failures'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
