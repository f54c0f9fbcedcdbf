"""Frames each seek decodes and drops before its target (the port's counter
gomp3.decoder.warmup_frames), per op."""

from benchmark import program_spans


def read(r: dict):
    k = program_spans.counter("gomp3.decoder.warmup_frames")
    return k / r["ops"] if k is not None and r.get("ops") else None
