"""Seeded arrival-process model for the soak engine (docs/scenarios.md).

A production year is not a constant load: demand breathes with the day,
spikes on deploy storms, and occasionally goes vertical when something
goes viral. The soak models that as three multiplicative terms, every
one a pure function of ``(seed, epoch)`` so a schedule is reproducible
bit-for-bit from the spec alone:

* **Poisson baseline** — the wave's pod count is drawn from a Poisson
  distribution around ``base_pods`` via a per-epoch derived
  ``np.random.default_rng`` stream.
* **Diurnal curve** — a cosine with period ``epochs_per_day`` and
  amplitude ``diurnal_amplitude`` modulates the mean (epoch 0 is the
  overnight trough, ``epochs_per_day / 2`` the midday peak).
* **Flash crowds** — with probability ``flash_prob`` an epoch is a flash
  crowd and the mean is multiplied by ``flash_factor``. The coin is a
  keyed blake2b hash, not an RNG stream, so arming or reordering other
  draws can never shift which epochs flash.

No wall-clock anywhere: ``schedule(soak, seed)`` is the same tuple on
every host, which is what lets ``tools/soak_profile.py`` replay single
epochs serially and demand byte-identity.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np

from nydus_snapshotter_tpu_torch.scenario.spec import SoakSpec

__all__ = ["Wave", "unit_draw", "diurnal_factor", "wave_for", "schedule"]


@dataclass(frozen=True)
class Wave:
    """One epoch's arrival decision, fully determined by (seed, epoch)."""

    epoch: int
    pods: int
    reads_per_pod: int
    flash: bool
    diurnal: float
    rate: float  # the modulated Poisson mean the pod count was drawn from

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch, "pods": self.pods,
            "reads_per_pod": self.reads_per_pod, "flash": self.flash,
            "diurnal": self.diurnal, "rate": self.rate,
        }


def unit_draw(seed: int, epoch: int, salt: str) -> float:
    """Deterministic uniform in [0, 1) keyed by (seed, epoch, salt).

    A keyed hash rather than an RNG stream: adding a new draw elsewhere
    can never shift this one, so flash epochs (and the evolution model's
    mutation coins, which share this primitive) are stable across
    versions of the soak loop.
    """
    h = hashlib.blake2b(
        f"{seed}|{epoch}|{salt}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


def diurnal_factor(epoch: int, epochs_per_day: int, amplitude: float) -> float:
    """Cosine day curve: epoch 0 = trough, epochs_per_day/2 = peak."""
    if epochs_per_day <= 1 or amplitude <= 0.0:
        return 1.0
    phase = 2.0 * math.pi * (epoch % epochs_per_day) / epochs_per_day
    return 1.0 - amplitude * math.cos(phase)


def wave_for(soak: SoakSpec, seed: int, epoch: int) -> Wave:
    """The arrival decision for one epoch (pure in seed+epoch)."""
    diurnal = diurnal_factor(epoch, soak.epochs_per_day, soak.diurnal_amplitude)
    flash = unit_draw(seed, epoch, "flash") < soak.flash_prob
    rate = soak.base_pods * diurnal * (soak.flash_factor if flash else 1.0)
    # Derived per-epoch stream: the draw for epoch e never depends on
    # how many draws epoch e-1 consumed.
    rng = np.random.default_rng(seed * 100003 + epoch)
    # Clamp the Poisson tail at ~2x the mean: a one-in-a-thousand draw
    # must not turn a soak epoch into an unbounded thread storm.
    pods = max(1, min(int(rng.poisson(rate)), int(rate * 2.0) + 2))
    return Wave(
        epoch=epoch,
        pods=pods,
        reads_per_pod=soak.reads_per_pod,
        flash=flash,
        diurnal=diurnal,
        rate=rate,
    )


def schedule(soak: SoakSpec, seed: int) -> tuple:
    """The full wave schedule — ``soak.epochs`` deterministic waves."""
    return tuple(wave_for(soak, seed, e) for e in range(soak.epochs))
