"""Corpus-evolution model: images age between soak waves (docs/scenarios.md).

A year of production does not redeploy the same image: base layers get
patched, packages upgrade, configs churn. The chunk-dict/zdict planes
must keep earning their dedup under that drift, not just against the
frozen fixture trees. This module models the drift with the same
mechanism the committed tree2 manifest uses for its derivation: a file
"changes" by bumping its :func:`~.corpus.synth_content` generation, so
every unchanged byte stays bit-identical (and keeps deduping) while
changed files diverge realistically.

Determinism contract (same as :mod:`.arrivals`): whether path ``p``
mutates in epoch ``e`` is a keyed-hash coin ``unit_draw(seed, e,
"evolve|p") < drift_rate`` — a pure function of the spec, independent of
execution order. Generations are cumulative (a file that mutated in
epochs 2 and 5 is at ``base_gen + 2`` from epoch 5 on), so an epoch's
corpus can be re-materialized in isolation for serial replay.

Because the coin is a fixed uniform compared against ``drift_rate``, the
mutated set grows monotonically with ``drift_rate`` (and with epoch):
:func:`shared_fraction` — the fraction of bytes still at their base
generation, a proxy for the dict plane's dedup opportunity — decays
monotonically. ``tests/test_scenario_arrivals.py`` pins that property.
"""

from __future__ import annotations

import stat as statmod

from nydus_snapshotter_tpu_torch.scenario.arrivals import unit_draw
from nydus_snapshotter_tpu_torch.scenario.corpus import manifest_members

__all__ = ["mutations", "gen_of", "evolved_members", "shared_fraction"]


def mutations(seed: int, drift_rate: float, path: str, epoch: int) -> int:
    """How many times ``path`` has mutated by ``epoch`` (cumulative).

    Epoch 0 is the pristine corpus; the first coin lands in epoch 1.
    """
    g = 0
    for e in range(1, epoch + 1):
        if unit_draw(seed, e, f"evolve|{path}") < drift_rate:
            g += 1
    return g


def gen_of(manifest: dict, seed: int, drift_rate: float, epoch: int):
    """A ``gen_of(path)`` hook for :func:`~.corpus.manifest_members`.

    Drift stacks ON TOP of the manifest's own generations: tree2's
    derivation gens keep the cross-tree dedup relationship, and soak
    mutations age both trees coherently (a shared path that mutates
    reaches the same generation in either tree, so it still dedups).
    """
    base = {e["path"]: e.get("gen", 0) for e in manifest["entries"]}

    def _gen(path: str) -> int:
        return base.get(path, 0) + mutations(seed, drift_rate, path, epoch)

    return _gen


def evolved_members(manifest: dict, seed: int, drift_rate: float,
                    epoch: int) -> list:
    """The manifest's tar members as of ``epoch`` under the drift model."""
    return manifest_members(
        manifest, gen_of=gen_of(manifest, seed, drift_rate, epoch)
    )


def shared_fraction(manifest: dict, seed: int, drift_rate: float,
                    epoch: int) -> float:
    """Fraction of regular-file bytes still at their base generation.

    An analytic proxy for the dict plane's dedup opportunity against the
    pristine corpus — cheap enough for property tests (no conversion
    needed), monotone nonincreasing in both ``drift_rate`` and ``epoch``
    by construction.
    """
    total = changed = 0
    for e in manifest["entries"]:
        if not statmod.S_ISREG(e["mode"]) or e["size"] <= 0:
            continue
        total += e["size"]
        if mutations(seed, drift_rate, e["path"], epoch) > 0:
            changed += e["size"]
    return 1.0 if total == 0 else (total - changed) / total
