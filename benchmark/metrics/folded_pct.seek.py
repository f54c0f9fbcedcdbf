"""Share of ops whose first decode carried the seek's warm-up frames (the
port's counter gomp3.decoder.seek_folds over the window's ops), in %."""

from benchmark import program_spans


def read(r: dict):
    folds = program_spans.counter("gomp3.decoder.seek_folds")
    return 100.0 * folds / r["ops"] if folds is not None and r.get("ops") else None
