"""The SWIM gossip round on torch tensors (port of ``consul_tpu.gossip``)."""

from consul_tpu_torch.gossip.params import SwimParams, lan_profile, wan_profile  # noqa: F401
from consul_tpu_torch.gossip.kernel import (  # noqa: F401
    SwimState, init_state, run_rounds, swim_round)
from consul_tpu_torch.gossip.multidc import (  # noqa: F401
    MultiDCParams, MultiDCState, event_coverage, fire_in_dc, init_multidc,
    init_multidc_hist, make_params, multidc_round, run_multidc_rounds)
from consul_tpu_torch.gossip.crossval import (  # noqa: F401
    kernel_event_latencies, kernel_nemesis_stats, run_config,
    run_event_config, run_join_config, run_nemesis_config)
