"""Boot-time knob resolution for the port's gossip plane (the registry,
persistence and ``resolve`` of ``consul_tpu/obs/tuner.py``).

Each knob the plane reads (``gossip/plane.py`` ``TUNED_FIELDS``)
resolves in a strict order: explicit configuration > a persisted verdict
for this backend > the registry default.  A verdict is a JSON file per
platform (``verdict-cuda.json``, ``verdict-cpu.json``) in
``CONSUL_TPU_AUTOTUNE_DIR`` (default ``~/.cache/consul_tpu_torch/
autotune``), scoped to a fingerprint (platform x device count x torch
version); one settled for another backend is not applied.
``CONSUL_TPU_AUTOTUNE=0`` ignores verdicts.

The reference also settles verdicts from measured evidence (its evidence
adapters and decision rules read the repository's benchmark artifacts);
those are not part of the port yet, so a verdict here is one written by
an operator or a later tool, and without one every knob takes its
registry default and says so in its ``reason``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

VERDICT_FORMAT = 1

# Valid dissemination strategies a verdict may carry (the membership
# SwimParams.__post_init__ checks).
DISSEM_CHOICES = ("swar", "planes", "prefused", "fused")


@dataclass(frozen=True)
class Knob:
    """One standing knob: its default and where it lands."""

    default: Any
    kind: str                       # str | int | float | bool
    target: str                     # the config field the value lands on
    doc: str = ""
    choices: Tuple[str, ...] = ()   # for kind=str: valid values


# The knobs of the gossip plane, with the reference registry's defaults.
KNOBS: Dict[str, Knob] = {
    "dissem": Knob(
        default="swar", kind="str", choices=DISSEM_CHOICES,
        target="PlaneConfig.dissem",
        doc="Dissemination merge strategy for the kernel round."),
    "fused_nb": Knob(
        default=1, kind="int", target="PlaneConfig.fused_nb",
        doc="Column-block count of the fused tail's grid."),
    "hot_slots": Knob(
        default=0, kind="int", target="PlaneConfig.hot_slots",
        doc="Active-rumor top-k short-circuit in the dissemination "
            "sweep (0 = full sweep)."),
    "shard_devices": Knob(
        default=1, kind="int", target="PlaneConfig.shard_devices",
        doc="Column shards the SWIM round runs on."),
    "unroll": Knob(
        default=4, kind="int", target="PlaneConfig.unroll",
        doc="Kernel rounds fused per scan iteration (the reference's "
            "scan; the port's round loop takes no unroll)."),
    "flight_drain_every": Knob(
        default=16, kind="int", target="PlaneConfig.flight_drain_every",
        doc="Dispatches between flight-ring host drains."),
}


def _valid(knob: Knob, value: Any) -> bool:
    """A persisted verdict is operator input from disk: type- and
    domain-check before a boot applies it."""
    if knob.kind == "str":
        return isinstance(value, str) and (
            not knob.choices or value in knob.choices)
    if knob.kind == "bool":
        return isinstance(value, bool)
    if knob.kind == "int":
        return isinstance(value, int) and not isinstance(value, bool)
    if knob.kind == "float":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    return False


def fingerprint(platform: str, device_count: int) -> Dict[str, Any]:
    """Backend identity a verdict is scoped to: platform x topology x
    torch version."""
    import torch
    return {"platform": str(platform), "device_count": int(device_count),
            "torch": torch.__version__}


def verdict_dir() -> str:
    return os.environ.get(
        "CONSUL_TPU_AUTOTUNE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "consul_tpu_torch",
                     "autotune"))


def verdict_path(platform: str) -> str:
    return os.path.join(verdict_dir(), f"verdict-{platform}.json")


def enabled() -> bool:
    return os.environ.get("CONSUL_TPU_AUTOTUNE", "1") != "0"


def verdict_bytes(verdict: Dict[str, Any]) -> bytes:
    """Canonical serialization (sorted keys)."""
    return (json.dumps(verdict, indent=1, sort_keys=True) + "\n").encode()


def save_verdict(verdict: Dict[str, Any],
                 path: Optional[str] = None) -> Optional[str]:
    path = path or verdict_path(verdict["fingerprint"]["platform"])
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(verdict_bytes(verdict))
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def load_verdict(platform: str,
                 path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    try:
        with open(path or verdict_path(platform)) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) \
            or payload.get("format") != VERDICT_FORMAT \
            or not isinstance(payload.get("knobs"), dict):
        return None
    return payload


@dataclass
class Resolution:
    """One boot's knob resolution: per-knob rows + the metadata the
    ``autotune`` bridge frame reports."""

    rows: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def value(self, name: str) -> Any:
        return self.rows[name]["value"]

    def wire(self) -> Dict[str, Any]:
        # ``resettles`` keeps the reference frame's schema: the port
        # never re-settles a verdict.
        return {"knobs": dict(self.rows), **self.meta, "resettles": 0}


def resolve(names: Sequence[str], explicit: Dict[str, Any],
            platform: str, device_count: int) -> Resolution:
    """Per knob: explicit configuration > persisted verdict for this
    fingerprint > registry default.  ``explicit`` maps knob name ->
    value for knobs the operator actually set (absent/None = unset)."""
    fp = fingerprint(platform, device_count)
    verdict, foreign = None, False
    if enabled():
        verdict = load_verdict(fp["platform"])
        if verdict is not None and verdict.get("fingerprint") != fp:
            verdict, foreign = None, True
    res = Resolution(meta={
        "fingerprint": fp,
        "verdict_path": verdict_path(fp["platform"]),
        "verdict_found": verdict is not None,
        "autotune_enabled": enabled(),
        "evidence_epoch_unix": (verdict or {}).get(
            "evidence_epoch_unix", 0.0),
    })
    vknobs = (verdict or {}).get("knobs", {})
    for name in names:
        knob = KNOBS[name]
        if explicit.get(name) is not None:
            res.rows[name] = {
                "value": explicit[name], "source": "flag",
                "evidence": [], "reason": "explicit configuration"}
            continue
        vk = vknobs.get(name)
        if isinstance(vk, dict) and _valid(knob, vk.get("value")):
            res.rows[name] = {
                "value": vk["value"],
                "source": ("verdict" if vk.get("source") == "evidence"
                           else "default"),
                "evidence": list(vk.get("evidence") or []),
                "reason": str(vk.get("reason", ""))}
        else:
            res.rows[name] = {
                "value": knob.default, "source": "default", "evidence": [],
                "reason": ("autotune disabled" if not enabled() else
                           "verdict settled for another backend"
                           if foreign else "no verdict for this knob")}
    return res
