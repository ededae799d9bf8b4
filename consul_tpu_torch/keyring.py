"""Read-only gossip keyring file parsing for the port's daemon (the
load-and-validate half of ``consul_tpu/agent/keyring.py``).

A keyring file is a JSON list of base64 16-byte keys, primary first (the
serf snapshot format).  ``gossipd --keyring-file`` arms the plane's
registration proof with every key in it; a malformed file must fail
loudly at boot, not arm the plane with keys that refuse every agent.
"""

from __future__ import annotations

import base64
import json
import os
from typing import List

KEY_LEN = 16


class KeyringError(ValueError):
    pass


def _validate(key: str) -> bytes:
    try:
        raw = base64.b64decode(key, validate=True)
    except (ValueError, TypeError):
        raise KeyringError("Invalid key: not base64")
    if len(raw) != KEY_LEN:
        raise KeyringError(f"Invalid key: expected {KEY_LEN} bytes, "
                           f"got {len(raw)}")
    return raw


def list_keys(path: str) -> List[str]:
    """The keys of the keyring file at ``path``, primary first, each
    validated."""
    if not path or not os.path.exists(path):
        raise KeyringError("no keyring file and no initial key")
    with open(path) as f:
        keys = json.load(f)
    if not isinstance(keys, list) or not keys:
        raise KeyringError(f"keyring file {path} is invalid")
    for k in keys:
        _validate(k)
    return list(keys)
