"""The output check: the program's PCM against the plain reference's.

Each answer (a clip, or the PCM of a read) is compared whole with what a
linear decode by benchmark/reference gives. The numbers compared, with the
limits of the configuration's guarantee (ISO/IEC 11172-4 full accuracy):
 - length_mismatches: answers whose byte length differs (limit 0);
 - max_abs_lsb: the largest |difference| of any sample (limit 2 LSB);
 - rms_lsb: the largest RMS difference of an answer (limit 0.289 LSB).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Compared:
    limits: dict
    answers: int = 0
    length_mismatches: int = 0
    max_abs_lsb: int = 0
    rms_lsb: float = 0.0
    worst: list = field(default_factory=list)

    def add(self, got: bytes, want: bytes, label: str = "") -> None:
        self.answers += 1
        if len(got) != len(want):
            self.length_mismatches += 1
            self.worst.append(f"{label}: {len(got)} bytes, want {len(want)}")
            n = min(len(got), len(want)) // 2 * 2
            got, want = got[:n], want[:n]
        if not want:
            return
        d = np.frombuffer(got, "<i2").astype(np.int32) - np.frombuffer(want, "<i2")
        mx = int(np.abs(d).max())
        rms = float(np.sqrt(np.mean(d.astype(np.float64) ** 2)))
        self.max_abs_lsb = max(self.max_abs_lsb, mx)
        self.rms_lsb = max(self.rms_lsb, rms)

    def numbers(self) -> dict:
        """name -> {"value", "limit"}, in a fixed order."""
        return {
            "length_mismatches": {"value": self.length_mismatches,
                                  "limit": self.limits["length_mismatches"]},
            "max_abs_lsb": {"value": self.max_abs_lsb,
                            "limit": self.limits["max_abs_lsb"]},
            "rms_lsb": {"value": self.rms_lsb, "limit": self.limits["rms_lsb"]},
        }

    def ok(self) -> bool:
        return self.answers > 0 and all(
            v["value"] <= v["limit"] if k != "rms_lsb" else v["value"] < v["limit"]
            for k, v in self.numbers().items())
