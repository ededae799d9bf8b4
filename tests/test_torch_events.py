"""The port's user-event flood (consul_tpu_torch/gossip/events.py) against
the reference's (consul_tpu/gossip/events.py) on the CPU: ``fire_events``,
``event_round``, ``coverage`` and ``run_event_rounds`` under the same key
and inputs, every field bit-identical after every round, coverage equal
as float32 (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.gossip import events as je
from consul_tpu.gossip import params as j_params
from consul_tpu_torch.gossip import convert
from consul_tpu_torch.gossip import events as te
from consul_tpu_torch.gossip import params as t_params

pytestmark = pytest.mark.timeout_s(300)

# name -> (profile, n, event slots, params, dead fraction,
#          {round: firing nodes}, rounds).  Fires include -1 entries,
# repeated nodes and dead origins; "overflow" fires more events than
# slots, lets them age past event_ttl_rounds and fires into the freed
# slots again.
CASES = {
    "pushpull": ("lan_profile", 1000, 8, dict(pushpull_every=4), 0.0,
                 {0: [5, 900], 3: [-1, 17], 9: [17, 17, 400]}, 30),
    "no_pushpull": ("lan_profile", 1000, 8, dict(pushpull_every=0), 0.0,
                    {0: [1, 2, 2], 10: [3, -1]}, 30),
    "alive_holes": ("lan_profile", 1000, 8, dict(pushpull_every=5), 0.25,
                    {0: [0, 1, 2, 3], 6: [10, 11]}, 30),
    "overflow_gc": ("lan_profile", 600, 4, dict(pushpull_every=0), 0.1,
                    {0: [1, 2, 3, -1, 4, 5, 6], 2: [9], 20: [7, 8, 8, -1]},
                    36),
    "unaligned": ("lan_profile", 4001, 8, dict(pushpull_every=6), 0.05,
                  {0: [4000, 0], 5: [2000]}, 24),
    "wan": ("wan_profile", 500, 6, dict(pushpull_every=7), 0.1,
            {0: [3, 499], 4: [250, -1, 3]}, 28),
}


def _assert_same(js, ts, where):
    for f in je.EventState._fields:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, f)


@pytest.mark.parametrize("case", list(CASES))
def test_events_match_reference(case):
    profile, n, E, kw, dead, fires, rounds = CASES[case]
    jp = getattr(j_params, profile)(n, **kw)
    tp = getattr(t_params, profile)(n, **kw)
    if case == "overflow_gc":
        assert rounds > 20 + tp.event_ttl_rounds > 2 + tp.event_ttl_rounds
    rng = np.random.default_rng(len(case))
    alive = rng.random(n) >= dead
    for nodes in fires.values():  # every origin fires as a member
        alive[[i for i in nodes if i >= 0][:1]] = True
    jkey = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
    tkey = convert.key_from_numpy(np.asarray(jkey))
    j_alive, t_alive = jnp.asarray(alive), torch.from_numpy(alive)

    js = je.init_events(jp, slots=E)
    ts = te.init_events(tp, slots=E, device="cpu")
    _assert_same(js, ts, "init")
    for r in range(rounds):
        if r in fires:
            nodes = np.asarray(fires[r], np.int32)
            js = je.fire_events(js, jnp.asarray(nodes))
            ts = te.fire_events(ts, torch.from_numpy(nodes))
            _assert_same(js, ts, f"fire@{r}")
        js = je.event_round(js, jkey, j_alive, jp)
        ts = te.event_round(ts, tkey, t_alive, tp)
        _assert_same(js, ts, f"round {r}")
        jc = np.asarray(je.coverage(js, j_alive))
        tc = te.coverage(ts, t_alive).numpy()
        assert jc.dtype == tc.dtype == np.float32
        assert np.array_equal(jc, tc), r
    js_drops = int(js.drops)
    if case == "overflow_gc":
        assert js_drops == 3 and not bool(js.slot_used[:3].all())
    # The scan entry point, from where the stepwise run ended.
    js, jcov = je.run_event_rounds(js, jkey, j_alive, jp, steps=6)
    ts, tcov = te.run_event_rounds(ts, tkey, t_alive, tp, steps=6)
    _assert_same(js, ts, "run_event_rounds")
    assert tcov.dtype == torch.float32 and tuple(tcov.shape) == (6, E)
    assert np.array_equal(np.asarray(jcov), tcov.numpy())
    assert int(ts.n_seen.sum()) > 0


def test_event_state_carries_across():
    """convert.state_from_numpy takes the reference's EventState field by
    field (the plane's session carries across as numpy)."""
    p = j_params.lan_profile(300)
    js = je.fire_events(je.init_events(p, slots=4), jnp.asarray([7, -1, 9]))
    ts = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")
    assert isinstance(ts, te.EventState)
    _assert_same(js, ts, "converted")
    back = convert.state_to_numpy(ts)
    assert all(np.array_equal(back[f], np.asarray(getattr(js, f)))
               for f in js._fields)
