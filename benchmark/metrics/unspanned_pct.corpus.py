"""The share of decode_corpus_fast's time (the port's span gomp3.corpus.call)
that none of its inner spans (parse, pack, emit, wait) covers."""

from benchmark import program_spans


def read(r: dict):
    return program_spans.own_pct(["gomp3.corpus.call"])
