"""The port on a CUDA card: the Hopper dissemination kernel against its
plain torch version, and the whole round loop on the card against the
same loop on the CPU.  Exact: belief bytes and every state field are
compared bit for bit.

Every test here carries the ``cuda`` marker and skips without a card.
This file imports torch and numpy only (no JAX), so it runs on a GPU
machine that has no JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from consul_tpu_torch import prng
from consul_tpu_torch.gossip import fused
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip.params import SwimParams

NEVER = 2**31 - 1

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _random_round_inputs(S, N, seed):
    """Every belief byte value (message, confirmation count, age with the
    fresh sentinel), senders dead/alive/non-member, receivers on and off,
    caps 0..3."""
    rng = np.random.default_rng(seed)
    heard = rng.integers(0, 256, (S, N)).astype(np.uint8)
    mf = rng.choice(np.asarray([-1, 10, 200, NEVER], np.int32), (N,))
    rx_ok = rng.random(N) < 0.9
    cap = rng.integers(0, 4, (S,)).astype(np.int32)
    return heard, mf, rx_ok, cap


@pytest.mark.parametrize("shape", [(4, 24), (6, 40), (16, 96), (64, 4099)])
def test_kernel_matches_plain_on_card(shape):
    _need_card()
    S, N = shape
    heard, mf, rx_ok, cap = (torch.from_numpy(a).cuda()
                             for a in _random_round_inputs(S, N, seed=N))
    p = SwimParams(n=N, slots=S)
    for offs in ([1, N - 1, 7], [3], [N - 1] * 8):
        ref = fused.disseminate_ref(p, 50, offs, heard, mf, rx_ok, cap)
        out = fused.fused_dissem(heard, offs, mf, rx_ok, cap, 50,
                                 p.spread_budget_rounds)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), offs


def test_round_on_card_matches_cpu():
    """run_rounds with joins, loss, push/pull, the hot tier, the flight
    ring and the hist banks: the card (Hopper kernel) against the CPU
    (plain tail)."""
    _need_card()
    n = 240
    join = np.full(n, NEVER, np.int32)
    join[10:14] = 5
    fail = np.full(n, NEVER, np.int32)
    fail[40], fail[170] = 20, 50
    p = SwimParams(n=n, slots=16, probe_every=5, loss_rate=0.05,
                   pushpull_every=20, hot_slots=4)
    launches0 = fused.launches
    outs = []
    for dev in ("cuda", "cpu"):
        st = tk.init_state(p, device=dev)._replace(
            member=torch.from_numpy(join == NEVER).to(dev))
        outs.append(tk.run_rounds(st, prng.key(2), fail, p, 200,
                                  trace=True, join_round=join,
                                  flight=tk.init_flight(device=dev),
                                  hist=tk.init_hist(device=dev), device=dev))
    assert fused.launches > launches0
    (cg, tg), (cc, tc) = outs
    for a, b in list(zip(cg, cc)) + [(tg, tc)]:
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
