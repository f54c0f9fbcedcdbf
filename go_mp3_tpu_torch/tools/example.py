"""Playback example on the port (example/main.py's counterpart, after the
reference's example/main.go).

    python -m go_mp3_tpu_torch.tools.example [input.mp3] [output.wav] [--device cuda|cpu]

Decodes an MP3 through the port's Decoder (its DSP on --device, the card
by default) and plays it on the default audio device when simpleaudio is
installed; otherwise streams the PCM into a WAV file. Defaults: input
conformance/synthetic_escape.mp3, output /tmp/out.wav.
"""

from __future__ import annotations

import argparse
import struct

from ..decoder import Decoder
from .cardtime import device_label
from .corpus import ESCAPE


def wav_header(n_pcm_bytes: int, sample_rate: int) -> bytes:
    """Minimal RIFF/WAVE header for s16le stereo."""
    byte_rate = sample_rate * 4
    return (
        b"RIFF"
        + struct.pack("<I", 36 + n_pcm_bytes)
        + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 2, sample_rate, byte_rate, 4, 16)
        + b"data"
        + struct.pack("<I", n_pcm_bytes)
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m go_mp3_tpu_torch.tools.example",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="?", default=str(ESCAPE))
    ap.add_argument("dst", nargs="?", default="/tmp/out.wav")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the Decoder's DSP runs (default cuda)")
    args = ap.parse_args(argv)

    with open(args.src, "rb") as f:
        d = Decoder(f, device=args.device)
        print(f"{args.src}: {d.sample_rate()} Hz, {d.duration():.2f}s, "
              f"{d.sample_count()} samples; device {device_label(d.device)}")

        try:  # live playback when an audio stack exists
            import simpleaudio

            pcm = d.read_all()
            play = simpleaudio.play_buffer(pcm, 2, 2, d.sample_rate())
            play.wait_done()
            return 0
        except ImportError:
            pass

        # pull-based streaming decode into a WAV (the decoder is an
        # io.Reader-style object; stream rather than materialize)
        with open(args.dst, "wb") as out:
            out.write(wav_header(d.length(), d.sample_rate()))
            while True:
                chunk = d.read(1 << 16)
                if not chunk:
                    break
                out.write(chunk)
        print(f"wrote {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
