"""The port's round at the reference's own slot provisioning, past the
1,024 slots the card's one-block kernels took before their wide forms:
``crossval.run_nemesis_config`` sizes a partition's run at
``max(64, next_pow2(n))`` slots, so ``partition_heal`` at n = 2,048 runs
with S = 2,048.  The port's CPU round (its plain versions) against the
reference's ``run_rounds`` on the CPU, tolerance 0: every field of
``SwimState``, ``HistBank``, ``NemState`` and the ``RoundTrace``, over 30
rounds across the partition window's start (round 40), in which more than
1,024 slots go live at once.  The card's kernels at these shapes are held
against the same plain versions by ``tests/test_torch_*_on_host.py`` (the
sources under g++) and by ``chip_smoke.py --phase wide_slots``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip.params import SwimParams as TParams

pytestmark = pytest.mark.timeout_s(600)

N = S = 2048      # run_nemesis_config's default slots at n = 2,048
FIRST, STEPS = 25, 30  # rounds 25-54; the partition opens at round 40
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """Compile the reference with XLA's optimisations off (the same
    integers, quicker), as tests/test_torch_nemesis.py."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _reference():
    sc = j_nem.build("partition_heal", N)
    p = JParams(n=N, slots=S, probe_every=5)
    st = jk.init_state(p)
    st = st._replace(round=jnp.int32(FIRST))
    return jk.run_rounds(
        st, jax.random.PRNGKey(SEED), jnp.asarray(sc.fail_round), p, STEPS,
        trace=True, hist=jk.init_hist(), nem=sc.nem,
        join_round=jnp.asarray(sc.join_round),
        nem_state=jk.init_nem_state(N))


def _port():
    sc = t_nem.build("partition_heal", N)
    p = TParams(n=N, slots=S, probe_every=5)
    st = tk.init_state(p, device="cpu")
    st = st._replace(round=st.round.new_tensor(FIRST))
    return tk.run_rounds(
        st, prng.PRNGKey(SEED), sc.fail_round, p, STEPS, trace=True,
        hist=tk.init_hist(device="cpu"), nem=sc.nem,
        join_round=sc.join_round,
        nem_state=tk.init_nem_state(N, device="cpu"), device="cpu")


def _assert_fields_equal(ref, port, ctx):
    got = convert.state_to_numpy(port)
    for f in ref._fields:
        x = np.asarray(getattr(ref, f))
        assert x.dtype == got[f].dtype and x.shape == got[f].shape, \
            f"{ctx}{f}: {x.dtype}{x.shape} vs {got[f].dtype}{got[f].shape}"
        if not np.array_equal(x, got[f]):
            bad = np.argwhere(x != got[f])[:3] if x.ndim else "scalar"
            raise AssertionError(f"{ctx}{type(ref).__name__}.{f} diverged "
                                 f"at {bad}")


def test_partition_heal_at_2048_slots_matches_reference():
    (rc, rtr), (pc, ptr) = _reference(), _port()
    assert len(rc) == len(pc)
    for a, b in zip(rc, pc):
        _assert_fields_equal(a, b, "partition_heal S=2048 ")
    _assert_fields_equal(rtr, ptr, "partition_heal S=2048 trace ")
    st = pc[0]
    # Not vacuous: the partition opened more suspicion episodes than the
    # one-block kernels' 1,024 slots held, and none was dropped.
    live = int((st.slot_node >= 0).sum())
    assert live > 1024, live
    assert int(st.drops) == 0
    assert int(st.round) == FIRST + STEPS
