"""The port's measuring and checking tools (the counterparts of tools/ and
example/), each run as `python -m go_mp3_tpu_torch.tools.<name>`, on the
card unless the caller passes `--device cpu`:

  compliance      ISO/IEC 11172-4 verdict of one file against an oracle
                  (another backend or an external decoder command)
  bench_single    single-stream MB/s and x realtime per backend
  profile_device  per-stage card time of the chunk decode, with its bound
  profile_decode  the host parse profile and a torch.profiler trace of the
                  card (busy share, kernel time by name, idle gaps)
  fuzz_soak       packed8 against int16 native parse parity on mutants
  example         decode to a WAV file (or play it)
  parse_corpus_bench  the bench's full-corpus parse probe alone (host only)
  bench_compare   a fresh `python -m go_mp3_tpu_torch.bench` against a saved
                  baseline line

and the pieces they share with chip_smoke.py: `cardtime` (the card timer,
the card's identity and the bound arithmetic) and `corpus` (the rotated
corpus lanes built from the repo's two bitstreams).
"""
