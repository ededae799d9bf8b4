"""Flight-row columns and histogram bank sizes, copied from the reference
(``consul_tpu/obs/flight.py`` and ``consul_tpu/obs/hist.py``).

The round writes flight rows and bank buckets in exactly these layouts,
so the reference's host-side recorders can read the port's rings and
banks unchanged.  ``tests/test_torch_isolation.py`` pins the copies
against the originals.
"""

# Column layout of one flight row, in the order the round builds it.
FLIGHT_COLS = (
    "round",             # kernel round counter at row write
    "probes",            # direct probes fired this round
    "acks_missed",       # direct probes whose ack window closed empty
    "indirect_probes",   # indirect (k-rescue) escalations
    "suspect_new",       # fresh suspicion verdict timers armed
    "alive_events",      # refutations applied (suspect -> alive)
    "dead_events",       # dead verdicts fired (incl. false positives)
    "join_rumors",       # slots still in join/bootstrap phase
    "queue_occupancy",   # occupied rumor slots (active verdicts)
    "dissem_bytes",      # gossip payload bytes pushed this round
    "drops",             # cumulative rescue-slot drops delta
    "members",           # live member count after the round
)
N_COLS = len(FLIGHT_COLS)

# Latency banks: one round per bucket plus a top overflow bucket.
LATENCY_BUCKETS = 256
# Spread bank: log2 buckets of the verdict-holder count.
SPREAD_BUCKETS = 32
