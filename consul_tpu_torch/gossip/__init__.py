"""The SWIM gossip round on torch tensors (port of ``consul_tpu.gossip``)."""

from consul_tpu_torch.gossip.params import SwimParams, lan_profile, wan_profile  # noqa: F401
from consul_tpu_torch.gossip.kernel import (  # noqa: F401
    SwimState, init_state, run_rounds, swim_round)
