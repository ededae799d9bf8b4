#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``consul_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase event_flood   # that phase alone (A/B)
    python3 chip_smoke.py --phase observe       # that phase alone (A/B)
    python3 chip_smoke.py --phase finish        # that phase alone (A/B)
    python3 chip_smoke.py --phase probe         # that phase alone (A/B)
    python3 chip_smoke.py --phase finish_slots  # that phase alone (A/B)
    python3 chip_smoke.py --phase branch        # branch_check alone
    python3 chip_smoke.py --phase loop          # the loop's checks alone
    python3 chip_smoke.py --phase draws         # the threefry kernels alone
    python3 chip_smoke.py --phase wide_slots    # S past 1,024 alone

Each phase prints one JSON line; any failure exits non-zero and the
result lines are not printed.

1. card: ``nvidia-smi`` name and power limit, torch's device name/count.
2. build: ``csrc/dissem_tail.cu`` (both entry points, ``fused_dissem``
   and ``fused_merge``), ``csrc/kv_store.cu``,
   ``csrc/threefry.cu``, ``csrc/round_graph.cu`` (the round
   program's conditional nodes), ``csrc/event_flood.cu`` (the event
   round), ``csrc/observe.cu`` (the round's observers' counts),
   ``csrc/finish.cu`` (the finish step's fire pass and row wipes),
   ``csrc/probe.cu`` (the probe tick) and ``csrc/finish_slots.cu`` (the
   finish step's slot logic) with nvcc for sm_90a, one nvcc each, all
   started together (ptxas report).
   threefry: every entry point of the round's draws
   (``consul_tpu_torch/prng.py``: bits, uniform, uniform rows, below,
   randint, edge drops) against its plain torch version on the card, bit
   for bit, over 16 keys (4 at 1M elements; keys with the high bit set
   among them), at the 1M paths' shapes (the drop legs' [3, 1M] and
   [2, 1M] under asym_loss's and partition_heal's probabilities, the
   Feistel targets' [1M]; the probe tick's former [200,000] and
   [200,000, 3]) and at odd lengths; per shape the kernel's time
   (CUDA-graph replays and back-to-back wrapper calls), the plain
   version's, and the bound: output bytes over the memory rate, or the
   hashed elements times the SASS count per element of the entry point's
   loop (``sass_count.py --threefry``; for the edge drops, which hash
   only their uncertain edges, the uniform's loop: a hash and its float)
   over the INT32 rate.  Where ``build/parent`` (git-ignored) holds a
   checkout of another commit (``git archive <commit> | tar -x -C
   build/parent``), its ``threefry.cu`` and ``round_table.cu`` are built
   too and every shape is also timed through them, in turns parent,
   this tree, this tree, parent (``parent_ms``; ``--phase draws`` runs
   this phase and the table's, ``table_vs_plain``, alone).
3. sass: the instructions per 32-bit word in the word path's row loop at
   fanout 3, per execution unit, one alignment way
   (``consul_tpu_torch/sass_count.py``, cuobjdump); and in the event
   flood's slot loop at fanouts 3 and 4 (``sass_count.py --flood``).
4. kernel: the Hopper dissemination kernel against its plain torch
   version on the card (with and without a drop operand), adversarial
   bytes at [64, 1M], [8, 1M], the ragged [64, 16,001], the multi-DC
   LAN pool's [64, 250,000] and [8, 250,000] and the crossval widths
   [64, 10,000] and [64, 1,000], each under
   offset triples that start with 1,
   N-1 and a random one and together cover every residue mod 16;
   byte-identical results required (the round and shifts read from
   device memory as ``[rnd, o_0 ..]``, the kernels' only form, once also
   with shifts off by -N); kernel time (``ms``: CUDA events
   over replays of a CUDA graph of 20 launches, the first triple; and
   ``eager_ms`` over back-to-back wrapper calls, which the wrapper's host
   time sets at small shapes), the plain version's time and the bound:
   the larger of the bytes over the memory rate and the per-byte rule's
   operations, counted four bytes to a 32-bit word (or the SASS count of
   the busiest execution unit where that is lower), over that unit's 32-bit
   integer rate.
5. merge_kernel: the sharded round's merge (``fused_merge``, all shards
   in one launch) against the plain composition ``merge_shards_ref`` in
   the same way, at [64, 1M] and [8, 1M] on 8 shards, at n = 16,000 on
   1, 2, 4 and 8 shards, at [64, 250,000] and [8, 250,000] on 8 shards
   of 31,250 and at [64, 10,000] on 8 shards of 1,250, with offsets
   above L.  Its bound is kernel 1's
   at the same [S, N]: the function is the same.
6. repeat: both kernels at [8, 1M] (the merge on 8 shards) over many
   seeds, each seed with its own offset triple and three launches, every
   launch byte-identical to the plain version.
6b. event_flood: the event round's kernel (``csrc/event_flood.cu``)
   against ``event_flood_ref`` on the card, tolerance 0 in every output
   (the bytes, slot_used, origin, node_ltime, n_seen), at [32, 250,000]
   (the multi-DC LAN pool), [64, 1M] (the plane), [32, 12] (the WAN pool,
   fanout 4) and [64, 16,001], over rows with shifts 1 and N - 1, random
   ones and the same off by -N, push/pull off and on, budgets 1, 3 and
   14, on inputs with every byte value, alive holes, slots on both sides
   of their TTL and clocks and counts at the int32 edge; then [32,
   250,000] over 64 seeds.  Its time (CUDA-graph replays of 20 launches,
   the row read from device memory) as the event program launches it
   (outputs and scratch kept) with push/pull off and on, and through the
   wrapper alone; the plain version's; and the bound: the bytes (has read
   and written, alive, node_ltime read and written) over the memory rate
   or the rule's operations (``flood_ops_per_word``, counted by hand) over
   the INT32 rate, the larger, with the kernel's slot loop's SASS a word
   (``sass_count.py --flood``) beside it.  ``--phase event_flood`` runs
   the card line, the flood's build and SASS count and this phase alone,
   so that two checkouts can be timed on one card in one call.
6c. observe: the round's observers' kernel (``csrc/observe.cu``,
   ``heard_counts``) against ``heard_counts_ref`` on the card, tolerance 0
   in every count, at [64, 1M] (the 1M round's final matrix), [32,
   250,000] (a multi-DC LAN pool), [64, 16,001] (the byte path), [64,
   250,000] on 8 shards of 31,250 (L % 16 == 2), [64, 1M] on 8 shards and
   [8, 1M] (the hot tier's rows), over 64 seeds each (every byte value,
   member holes, verdicts DEAD, REFUTE and out of range), in the forms
   the round launches it (every row and no verdict: dead, refute and
   live; a verdict and a want mask with holes: the holders; no row
   wanted; at [64, 1M], 1 and 3 rows wanted), budgets 0 to 16 on the
   first seed.  Its time in each form (CUDA-graph replays of 20
   launches), the plain version's, and the bound: the bytes (the rows
   read and member once, the counts written) over the memory rate or the
   form's operations (``observe_ops_per_word``, counted by hand, or the
   row loop's SASS, ``sass_count.py --observe``, where fewer) over the
   INT32 rate, the larger.  ``--phase observe`` runs the card line, the
   kernel's build and this phase alone.
6d. finish: the finish step's kernels (``csrc/finish.cu``:
   ``fire_timers``, the refutation's byte and the timer fire, and
   ``wipe_rows``) against ``fire_timers_ref`` / ``wipe_rows_ref`` on the
   card, tolerance 0 in every byte and in ``fired``, at [64, 1M] (the 1M
   round), [32, 250,000] (a multi-DC LAN pool), [64, 16,001] (odd N),
   [64, 250,000] on 8 shards of 31,250 (L % 16 == 2), [8, 1M] (the hot
   tier's rows) and [64, 1M] on 8 shards of 125,000 (L % 16 == 8), over
   64 seeds each (every byte value, rx holes, the timer masks of every
   row, of two and of none, with and without the refutation, its columns
   on the shards' edges; the wipe of two rows and the last, of none and
   of all; every fourth seed with the shards and rx at odd byte
   offsets).  Times from CUDA-graph
   replays (20 launches a graph), the fire also on fresh bytes (replays
   of a restore of the matrix and the launch, less the restore's), the
   plain versions', each beside the
   bytes bound of the rows the launch reads and writes (the rule's
   operations, ``finish_ops_per_word``, counted by hand, over the INT32
   rate where that is larger).  ``--phase finish`` runs the card line,
   the kernels' build and this phase alone.
6e. probe: the probe tick's kernels (``csrc/probe.cu``:
   ``probe_lanes_slots``, the lanes and the slot step in one launch, and
   ``probe_rearm_marks``, the rearmed rows' wipe and the marks in one)
   against ``probe_lanes_ref`` then ``probe_slots_ref``, and
   ``finish.wipe_rows_ref`` then ``probe_marks_ref``, on the card,
   tolerance 0 in every field of the
   state, NemState and the scratch after each launch, over 64 seeds of
   each ``PROBE_CASES`` entry ([64, 1M] with B = 200,000, K = 3 at loss 0
   and 0.01, the partition legs by hash and by halves at 0 < p < 1 and at
   p = 1, degraded observers with NemState; 16,001 with padding lanes, K
   3 and 0, and with 600 slots, the slot step in chunks; 8 shards of
   [64, 1M]; the WAN pool's [32, 12] with B = 2), each state with free,
   SUSPECT, DEAD, REFUTED and JOIN slots and more needy targets than free
   slots (every state must initiate and allocate or drop; rearms and
   drops must occur, and marks in rearmed rows).  Times from CUDA-graph
   replays of the whole tick and of each kernel (the wipe and marks with
   no rearmed row and with three), the plain versions', on each case's
   state and on the 1M main path's data (1 and 8 shards, and
   ``partition_heal``'s window), beside the bound (``_probe_bound``: the
   bytes the data needs, and the hashes at the SASS count of a uniform
   element, ``sass_count.py --threefry``); both kernels' SASS
   (``sass_count.py --probe``).  ``--phase probe`` runs the card line,
   the builds and this phase alone.
6f. finish_slots: the finish step's slot kernels
   (``csrc/finish_slots.cu``: ``finish_decide``, ``finish_settle``,
   ``finish_record``, with ``fire_timers``, the spread's
   ``heard_counts`` and ``wipe_rows`` between them as the round runs
   them) against ``finish_decide_ref``, ``finish_settle_ref`` and
   ``finish_record_ref`` on the card, tolerance 0 in every field of the
   state, the banks, LHM and every output after every launch, over 32
   seeds of each ``FINISH_SLOTS_CASES`` entry (the 1M main path's S = 64
   with every slot, its hot tier's 8 rows, 8 shards, the multi-DC LAN
   pool's 250,000 with hot tier 8 and WAN pool's 12 nodes and 32 slots,
   the hist banks and LHM on and off; at 16,000-16,001 states where every
   row fires, every row expires, or detections share buckets with the
   counters and banks near 2**31); the phase must see refutations, fires,
   detections, false dead verdicts, expiries, dropped members and spread
   rows.  Times from CUDA-graph replays of each kernel and of the whole
   step, the plain versions', on each case's state and on the 1M main
   path's data (1 and 8 shards, and with the banks), beside the bytes
   the data needs (``_finish_slots_bound``); the tail then decide as the
   round runs them (decide a programmatic dependent launch), the tail
   alone and the pair (``_tail_decide_times``), and whether the round's
   joined graph keeps decide's programmatic edge (``pdl_check``: the
   edges of the captured segment and of the IF node's body, the joined
   graph run and held against the eager tail and plain decide, on rows
   that refute only on the tail's output); the same for the spread's
   count then record with the banks (record a programmatic dependent
   launch: ``_count_record_times``, ``pdl_record_check``, held against
   the plain versions and the kernels run apart, on a row whose dropped
   subject's own byte is DEAD); and the fire then settle (settle a
   programmatic dependent launch behind the fire, its loads but ``fired``
   before its wait: ``_fire_settle_times``, the fire alone, settle alone
   and the pair; ``pdl_settle_check``, the pair in the joined graph on 1
   and 8 shards, its ``fired`` buffer holding the opposite verdicts until
   the fire writes it, held against the plain versions and the kernels
   run apart, on 7 rows that die only through ``fired``; the
   programmatic edge must be kept, one in the segment and one in the IF
   body).  ``--phase finish_slots`` runs the card line, the builds and
   this phase alone.
7. full_path: ``run_rounds`` at n=16,000, S=64 (lan_profile, churn,
   loss, joins, flight ring, hist banks, trace) once on the card and
   once on the CPU (a worker process started with the script, which runs
   while the kernel phases do); every field of the carry and the trace
   must be bit-identical; the observers' kernel launched once a round
   (the trace and the flight row) and once a non-quiescent round (the
   hist banks' spread), and no more (gated here, on 8 shards in 8, and on
   the main paths, round_program, crossval, multidc_full_path and the
   plane wherever those thread an observer).  On every path, the finish
   step's kernels at their exact count: ``fire_timers`` once a
   non-quiescent round, ``wipe_rows`` once a round (the probe tick's
   rearm), once a join round (the stale wipe) and once a non-quiescent
   round (the GC), each of the probe tick's kernels once a round and
   each of the finish step's slot kernels once a non-quiescent round, on
   every pool's rounds (gated here, in 8, on the main and nemesis main
   paths, nemesis_full_path, round_program's both routes, crossval, both
   multi-DC paths and the plane); on the graphed single-pool paths the
   belief matrix copied once a call and once a full-tail round, never in
   a quiescent or hot round (``program.copy_bytes``; the healthy main
   path: only the calls' loads), and round_program's caller state left
   bit-identical by both routes.
8. sharded_full_path: the same run through ``run_rounds_sharded(ndev=8)``
   on the card; every field must equal the card run of phase 7; merge
   launches = the non-quiescent rounds (one launch for all shards), none
   of fused_dissem; both the hot and the full tail must run.
8b. branch_check: the round program's chooser node
   (``csrc/round_graph.cu``'s ``choose_kernel``, one a branch group: the
   tail's switch, the join tick's cond) alone, ``program.Chooser``,
   against its plain version ``program.choose_ref`` (S 64, 32 and 1,024,
   hot tier off and 8, n_active at 0, 8, hot, hot + 1 and S; a cond on
   true and false; tolerance 0 in each branch's runs, ``branch_runs`` and
   n_active), its graph's time beside the plain version's and the bytes
   bound; then the graphed round against the eager round at n = 16,000,
   S = 64, hot tier 8, 160 rounds through every tail, on 1 and 8 shards,
   with and without join rounds: carry and trace bit-identical,
   ``tail_rounds`` and ``join_rounds`` counted by the choosers on the
   card equal to the eager host counts, the chooser launched once a
   replayed round and once more with a join tick, and every captured
   graph holding one chooser node per group (its only kernel nodes of
   its own) and the groups' IF nodes, read from the runtime's
   description of the graph.  Every path's launch gate holds the
   chooser's launches to that count (none on the eager route);
   round_program's profiled churn sees one ``choose_kernel`` a graphed
   round and no ``set_condition``, and then times the node alone by the
   profiler (a profiler session earlier in the process leaves later ones
   blind to kernels in conditional bodies).
8c. loop (also ``--phase loop``): the round program's loop
   (``csrc/round_graph.cu``: a WHILE node, ``loop_kernel``, then
   ``program.LOOP_ROUNDS`` round slots, each a SWITCH node over the
   captured variants; ``csrc/round_table.cu``'s ``table_kernel`` filling
   the chunk's table): first the nested graph, a segment with a
   programmatic edge (the tail then decide) under a cond's IF node in
   each slot's SWITCH body in a WHILE node, kept and held; the toy loop's
   table (an IF node a variant and one round an iteration, one SWITCH
   node a round, 2, 4 and 8 rounds an iteration; 2 and 10 variants; 512,
   4 and no rounds), every form and launch against ``program.loop_ref``
   (chunks of 0 to 512 rounds, a code it was not built with at the first,
   a middle and the last slot of an iteration), and the slots it favours;
   the nesting's cost (a healthy 1M round's joined graph from the host,
   inside an IF node, inside a WHILE iteration's IF node, and 30 of it
   as one launch of the loop); ``table_kernel``
   against its host twin over 320 draws of
   (parameters, key, first round, rows) and the multi-DC pools' launch,
   timed at 512, 30 and 1 rows beside the host build and the bound (and
   a parent checkout's kernel in turns, as the threefry phase); looped
   calls against the per-round replays and the eager route at 16,000
   (churn with joins on 1 and 8 shards, ``partition_heal``), two chunks,
   every launch gate exact; a looped call's kernels under the profiler
   equal to the host's counts.  On every single-pool path a call is one
   table launch and one graph launch a chunk of up to 512 rounds, the
   loop kernel ceil(n / U) a chunk of n rounds (multi-DC: 2 D + 3 graph
   launches a round,
   one table launch a call); round_program runs each case looped, with
   per-round replays and eagerly (carry and trace bit-identical), and
   profiles the looped route in a fresh worker process; the plane's
   lockstep adds a card plane replaying a round at a time; the
   programmatic edges of decide, settle and record are checked in the
   loop's nesting too.
8d. wide_slots (also ``--phase wide_slots``; before the main paths): S
   past the 1,024 slots the four slot-sized sources take in one block,
   where the host picks each one's wide instance.  Each kernel against
   its plain version, tolerance 0, and timed beside its bound at S =
   1,024, 1,025, 2,048, 8,192 and 16,384 on 16,000 columns and at
   [8,192, 1M]; the chooser at 8,192 (``CHOOSE_SHAPES``); the card's
   round against the CPU's (a worker) under ``partition_heal`` at [2,048,
   16,000] and [4,096, 16,000], 1 and 8 shards, bit-identical; path (a),
   ``crossval.run_config`` at 1M, 16 victims, 5 % loss, its own 8,192
   slots, graphed (completeness, false dead, p99 inside the Lifeguard
   envelope; slot drops, rounds/s, device ms a round and every wide
   kernel by name under the profiler, peak memory); path (b),
   ``run_nemesis_config`` for ``partition_heal`` and ``zone_kill`` at n =
   4,096 and its own 4,096 slots, kernel rows equal to
   ``CROSSVAL_WIDE.json`` (the port's CPU rows,
   ``tools/wide_nemesis_rows.py``); the plane at 2,048 slots with no
   tick error.  Its paths' shapes go to path_shapes (the tail's
   [8,192, 1M] held a block of rows at a time).
9. main_path: ``lan_profile(1_000_000, slots=64, hot_slots=0)`` with
   bench.py's churn1000ppm failure stride — warm-up, timed blocks each
   ending in a device->host read; rounds/s, kernel launches (must equal
   the non-quiescent rounds), host syncs per round, peak device memory;
   ``n_detected > 0`` and ``n_false_dead == 0`` required; draw launches
   per round, which must equal the device draws the paths asked for: none
   (the probe tick draws inside its own kernel).
10. sharded_main_path: the same churn run through
    ``run_rounds_sharded(ndev=8)``: rounds/s, merge launches (= the
    non-quiescent rounds), host syncs per round (equal to phase 9's),
    peak device memory; the final state, unsharded, must equal phase 9's
    field by field.  Then the same churn with the flight ring, hist banks
    and trace threaded (observers_main_path, 1 and 8 shards, final
    carries equal; the observers' kernel's launches gated, and none on
    the paths without an observer).  Then the healthy regime (no churn,
    single-device) for rounds/s.
    Since the round program (``gossip/program.py``), every card path
    above and below runs the graphed round: one graph launch a round
    (gated on the main paths), the launches of its kernels counted as
    captured launches times replays and branch bodies times their
    device-counted runs (``program.settle_counts()`` before every read;
    no gate changed), two host reads a call.
10b. round_program (after the nemesis main paths): the graphed round
    against the eager round (``graphed=False``) in this call at 1M, S =
    64: churn on one device and on 8 shards, healthy, and
    ``partition_heal`` across its window's start, each from the same
    state with the flight ring, hist banks and trace threaded; final
    state, ring, banks and the last block's trace bit-identical; the
    graphed call's host reads (2: round counter, flight cursor) and
    graph launches a round (1); rounds/s of both routes, captures, their
    seconds and the pool's bytes; for churn, device kernels and busy
    time a round and the idle share of both routes (torch.profiler), and
    the ``tail_kernel``, ``draw_kernel`` (none), ``finish::``,
    ``probe::`` and ``finish_slots::`` runs the profiler saw equal to the
    settled ``fused.launches``, ``prng.launches``, ``finish``'s,
    ``probe.launches`` and ``finish_slots.launches``, and the
    graphed churn round with the observers threaded profiled the same
    way (``counts_kernel`` runs equal to ``observe.launches``, its device
    ms a round); the observers' kernel launches of both routes gated.
11. events: the user-event flood (``gossip/events.py``) at E = 64,
    n = 16,000 for 300 rounds (fires with overflow, -1 entries and
    repeated nodes, push/pull rounds, an alive mask with holes, slot GC
    and reuse) on the card (the graphed route: replays of the event
    program, one ``event_flood`` launch a round, 300 launches gated) and
    on the CPU: every field and the coverage trace bit-identical.  Then
    at [64, 1M] with the plane's parameters: one fired event must reach
    coverage >= 0.99 within ``event_ttl_rounds``; with 64 live events the
    event round's time graphed and eager from one state (CUDA events over
    a call of 100 rounds ending in a device->host read), the two routes'
    states and coverage bit-identical, and peak device memory.
12. plane: the port's gossip plane in this process on the card, universe
    1M (capacity 1,024 + 998,976 simulated nodes, 64 slots, 64 event
    slots, 20 ms rounds, suspicion_mult 1.0, 0.3 s heartbeat lapse),
    serving 8 bridge clients (4-byte big-endian length + msgpack):
    every client sees member-join for all the others; a user event
    reaches every client and ``event_coverage()`` reaches 0.99; one
    client stops its heartbeats and every other client gets
    member-failed for it and for no one else; the stats frame shows
    ``n_false_dead == 0``; ``fused_dissem`` launched; the device frame
    reports the card's memory; the profile frame has no error; no tick
    error on stderr.  Rounds/s sustained, dispatch p50/p99 from the
    device frame, peak device memory.  Then the join and failure flow
    again with ``shard_devices=8``: ``fused_merge`` launched.
13. gossipd: ``python -m consul_tpu_torch.gossipd -nemesis
    partition_heal`` as a subprocess on the card at a small capacity; one
    client registers, gets its welcome and a stats frame; SIGTERM; exit
    code 0.

The nemesis phases (the catalog of ``gossip/nemesis.py``):

- kernel, merge_kernel and repeat hold both kernels with a drop operand
  too (a random one and ``partition_heal``'s full bisection with its
  window open), and report ``ms_drop`` beside ``ms``;
- nemesis_full_path (after 8): all six scenarios at n = 16,000, S = 64,
  each over its window, on the card against the CPU (worker processes)
  and on 8 shards against the single-device card run: every field of
  state, hist, NemState and trace bit-identical;
- nemesis_main_path and sharded_nemesis_main_path (after 10):
  ``partition_heal`` at 1M, S = 64, on 1 and 8 shards: rounds/s before
  the fault window, in its first 30 rounds and in the 60 after those,
  launches with a drop operand (one per round inside), host syncs per
  round (equal), final states equal;
- plane_nemesis (after 12): the plane under ``partition_heal`` at
  universe 1M with 8 bridge clients for 200 rounds (no tick error, the
  slo frame's scenario, launches with a drop operand), then the card
  plane in lockstep with the CPU plane at universe 16,384.

The cross-validation and multi-DC phases:

- multidc_full_path (after nemesis_full_path): ``run_multidc_rounds`` at
  D = 3, n_lan = 16,000, S = 64 for 200 rounds (LAN and WAN failures,
  events fired in two DCs and one past the last free slot, hist banks),
  with the hot tier off and on, on the card (the graphed route,
  ``MultiDCProgram``: D + 1 flood launches and 2 D + 3 graph launches a
  round, one host read a call) against the CPU workers' eager runs and
  with each DC's LAN pool on 8 column shards against the card's
  single-device run: state, banks and coverage trace bit-identical;
- crossval: ``crossval.run_config`` at n = 1,000 and 10,000 (16 victims,
  8 seeds) on the card, its kernel statistics equal to CROSSVAL.json's
  (at 1,000 the whole row: the oracle's seeds run in the CPU workers; at
  10,000 its recorded numbers stand in), seed 0 at 10,000 on 8 shards
  equal to one device, ``run_join_config`` and ``run_event_config`` rows
  equal to CROSSVAL.json's;
- crossval_nemesis: ``run_nemesis_config`` for every catalog scenario at
  n = 256, 2 seeds: its kernel side on the card equal to the port's row
  from a CPU worker (where the oracle runs), and the reference suite's
  gates on partition_heal and flapping;
- crossval_1m (after events): the kernel-only push/pull row at 1M
  (2 seeds), gated on completeness, false dead, slot drops and the
  Lifeguard envelope; rounds/s and launches;
- multidc_main_path and sharded_multidc_main_path: bench.py's multidc
  shape at 1M (4 DCs x 250,000, one event, 250 failures per DC), the
  eager route (``graphed=False``) and the graphed route
  (``MultiDCProgram``) from one state in this call, each a warm-up call
  of 20 rounds and 3 timed calls of 50: rounds/s of both, host reads a
  call (1 graphed) and a round, graph launches a round (2 D + 3),
  captures, their seconds and each program's pool bytes, the table's host
  ms a call, launches and peak memory; the states after every call
  bit-identical between the routes, D + 1 flood launches a round on both,
  the event at 0.99 of every DC on both; the 8-shard run's final state,
  after DEAD verdicts in every DC, equal to the single-device state.

Every card path (full_path, sharded_full_path, nemesis_full_path,
crossval, multidc_full_path, the main paths) reports its launches of the
draws' kernel, which must equal the device draws it asked for
(``prng.calls``): on the card every draw is one launch; since the probe
tick draws inside ``csrc/probe.cu``, a path without a nemesis partition
makes none.

Last, path_shapes: every (kernel, S, L, ndev, fanout, budget) that the
wrappers launched at after the kernel phases (``fused.launch_shapes``:
every path above, the WAN pool's fanout 4 and crossval_nemesis's
[256, 256] included) held against the plain version as in 4 and 5, with
fanout-sized offset sets, tolerance 0; and every (kernel, capacity, probe,
B) / (kernel, W, B, lmax) the store's phases launched its kernels at
(``device_store.launch_shapes``), on fresh random inputs against the
plain versions on the card; and every shape the draws' kernel was
launched at (``prng.launch_shapes``), with 4 fresh keys against the plain
version on the card; and every (E, N, F, budget, TTL, push/pull) the
event flood was launched at (``events.launch_shapes``), under 4 rows on
fresh inputs against the plain version; and every (R, L, ndev, budget,
verdict, want) the observers' counts were launched at
(``observe.launch_shapes``), on 4 fresh inputs against the plain
version; and every (kernel, R, L, ndev, refutation) the fire pass and
the wipe were launched at (``finish.launch_shapes``), on 4 fresh inputs
against the plain versions; and every (B, S, N, L, ndev, variant) the
probe tick's kernels were launched at (``probe.launch_shapes``), the
whole tick on 4 fresh states against the plain versions; and every (H,
S, N, L, ndev, variant) the finish step's slot kernels were launched at
(``finish_slots.launch_shapes``), the whole step on 4 fresh states
against the plain versions.

The device-resident state store (phase device_store, after gossipd;
``consul_tpu_torch/state/device_store.py``, kernels ``kv_apply`` and
``watch_match`` of ``csrc/kv_store.cu``):

- store_apply: ``kv_apply`` at capacity 65,536, probe 16, filled to half
  with keys shaped like the crossval's (over-lmax ones included), then
  20 batches each of 4,096, 64 and 1 op of the crossval's mix (set 0.55,
  CAS 0.15, delete 0.15, delete-tree 0.15; repeated keys inside a batch,
  indexes across 2**31): every batch's verdicts and the whole table
  equal to ``apply_ref``'s run in a CPU worker; a capacity-64 stream that
  exhausts its windows (``full`` > 0) and re-sets tombstoned keys;
  ``kv_apply`` ms a batch (CUDA-graph replays) and ``apply_ref``'s on the
  card at each size, beside the bytes bound;
- store_1m: capacity 1,048,576 with 500,000 keys, then 20 mixed batches
  of 4,096, indexes wrapping past 2**32, card only: every verdict equal
  to a dict model of the host's pre-state, but for keys the table
  dropped on a full probe window (counted in ``full``), which the script
  finds in the card's table and accounts for exactly;
- store_match: ``watch_match`` at 65,536 and 1,048,576 watches
  (tools/watchstorm.py's shape with key, prefix and table watches and
  min-index gates on both sides of 2**31), 256 events a batch in
  correlated bursts: ``fired`` and ``packed`` equal to ``match_ref`` on
  the card and to the notify copy's ``match_batch`` (CPU workers); ms
  and the plain version's ms, beside the operations bound;
- store_bridge: ``DeviceStoreBridge(capacity=65536)`` on the card over a
  dict stand-in of the host store with the 65,536 watchstorm watches, 50
  batches: divergence 0 at the table load this gives (a few percent of
  the slots, reported), every woken watch equal to ``match_batch``'s
  (CPU workers), occupancy equal to the store's live count, also after
  ``rebuild_from_store``; the kernels' launches here are the store's
  main path; ``on_batch`` ms split into encode, apply, match and the
  host walk;
- feistel: ``gossip_sources`` (n = 1,000,000, fanout 3),
  ``gossip_partners``, ``random_targets`` and ``feistel_permute`` on the
  card equal to the CPU's for two keys.

Then the kernels line (each kernel's launches on the main path, on the
plane's path as ``plane_launches``, with a drop operand on the nemesis
main paths as ``nemesis_launches``, in the crossval phase as
``crossval_launches`` and on the 1M multi-DC paths as
``multidc_launches``; for the store's kernels, their launches in
store_bridge; for the draws' kernel, its launches on the nemesis main
path, its time that path's gossip legs' drops [3, 1M] (and a parent
checkout's, ``parent_ms``, null without one, as for the table kernel);
for the round
program, its graph launches on the churn main path and a graphed round's
time against the eager round's; for its chooser node, its launches on the
churn main path, on 8 shards, on the 1M multi-DC path, on the plane and
in crossval, its time alone and in the graphed churn round; for the event
flood, its launches on the
1M multi-DC paths, in the events phase and on the plane, its time at
[32, 250,000] and [64, 1M]; for the observers' counts, their launches on
the 1M churn path with the observers threaded, on 8 shards, on the plane
and in crossval, their time at [64, 1M] in the final matrix's and the
spread's forms; for the finish step's fire pass and wipe, their
launches on the churn main path, on 8 shards, on the plane, in crossval
and on the 1M multi-DC path, their time at [64, 1M]; for the probe
tick's three kernels, their launches on the churn main path, on 8
shards, under partition_heal, on the plane, in crossval and on the 1M
multi-DC path, their time on the 1M main path's data; for the finish
step's three slot kernels, their launches on the churn main path, on 8
shards, with the observers, on the plane, in crossval and on the 1M
multi-DC path, their time on the 1M main path's data) and, last, the ok
line.  Needs
one CUDA card: without one it exits 2 before printing anything else.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import contextlib
import ctypes
import functools
import io
import json
import multiprocessing
import os
import select
import signal
import socket
import struct
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import msgpack
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
NEVER = 2**31 - 1
# H100 SXM peaks (NVIDIA data sheet, 700 W): the device memory rate, and
# the 8-bit integer rate of the tensor cores.  The merge's compares, maxima
# and selects cannot run on tensor cores: they run on the CUDA cores' 64
# INT32 lanes per SM, half the 128 FP32 lanes behind the sheet's 67 TFLOP/s
# of float32 (an FMA counts 2 FLOPs), so 67e12 / 4 integer ops/s.  The
# integer multiply-adds (IMAD) run on the FMA unit at the same 64 lanes
# per SM, beside the integer ALU, so each unit has this rate.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15
INT32_OPS_PER_S = 67e12 / 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` warm calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``replays`` times between CUDA events.
    Unlike back-to-back eager calls, this leaves out the wrapper's host
    time, which exceeds a small kernel's device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    torch.cuda.empty_cache()
    return ms


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed (rc {smi.returncode}): "
                           f"{smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


# The port's kernel sources (csrc/<name>.cu), one nvcc each: the gossip
# tail's entry points fused_dissem and fused_merge are in dissem_tail.cu,
# the device store's kv_apply and watch_match in kv_store.cu, the round's
# random draws in threefry.cu, the round program's conditional nodes in
# round_graph.cu, the event round in event_flood.cu, the round's
# observers' counts (heard_counts) in observe.cu, the finish step's fire
# pass and row wipes (fire_timers, wipe_rows) in finish.cu, the probe
# tick (probe_lanes_slots, probe_rearm_marks) in probe.cu, the finish
# step's slot logic (finish_decide, finish_settle, finish_record) in
# finish_slots.cu and the round program's table (table_kernel) in
# round_table.cu.
SOURCES = ("dissem_tail", "kv_store", "threefry", "round_graph", "event_flood",
           "observe", "finish", "probe", "finish_slots", "round_table")


def build() -> None:
    """Every kernel source of the port, one nvcc each, all started
    together."""
    from consul_tpu_torch import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        log = _build.build_logs.get(name, "(already built)")
        for ln in log.strip().splitlines():
            print(f"  nvcc {name}: {ln}", flush=True)
    emit({"phase": "build", "libraries": [so.name for so in libs],
          "seconds": time.perf_counter() - t0})


# A checkout of another commit (git-ignored), whose threefry.cu and
# round_table.cu the draws' and the table's timings run beside this tree's.
PARENT = ROOT / "build" / "parent"
PARENT_SOURCES = ("threefry", "round_table")


@functools.lru_cache(maxsize=None)
def _parent_libs():
    """The parent checkout's ``threefry.cu`` and ``round_table.cu``, built
    with this tree's nvcc flags into ``build/parent-lib<name>.so`` and
    loaded, by name; None without a parent checkout."""
    from consul_tpu_torch import _build
    src = PARENT / "consul_tpu_torch" / "csrc"
    if not all((src / f"{n}.cu").exists() for n in PARENT_SOURCES):
        return None
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(name):
        so = _build.BUILD_DIR / f"parent-lib{name}.so"
        r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(src / f"{name}.cu")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n"
                               f"{r.stdout}{r.stderr}")
        return ctypes.CDLL(str(so))

    with ThreadPoolExecutor(len(PARENT_SOURCES)) as pool:
        libs = dict(zip(PARENT_SOURCES, pool.map(one, PARENT_SOURCES)))
    emit({"phase": "parent_build", "checkout": str(PARENT),
          "libraries": sorted(libs)})
    return libs


@contextlib.contextmanager
def _parent_kernels():
    """The wrappers of ``prng`` and ``round_table`` launch the parent's
    kernels (the entry points and arguments are the same) inside the
    block."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import round_table
    libs = _parent_libs()

    @functools.lru_cache(maxsize=None)
    def draws(name):
        fn, err = getattr(libs["threefry"], name), libs["threefry"].threefry_error
        fn.argtypes, fn.restype = prng._ARGTYPES[name], ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        return fn, err

    @functools.lru_cache(maxsize=None)
    def table():
        lib = libs["round_table"]
        fn, err = lib.round_table_fill, lib.round_table_error
        fn.argtypes = [ctypes.POINTER(round_table._Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        return fn, err

    old = prng._lib, round_table._lib
    prng._lib, round_table._lib = draws, table
    try:
        yield
    finally:
        prng._lib, round_table._lib = old


def _turns(fn, timer) -> dict:
    """``timer(fn)`` through this tree's kernels, and with a parent
    checkout through its kernels too, in turns parent, this tree, this
    tree, parent: ``ms`` (the first of this tree's turns), ``ms_turns``,
    and ``parent_ms`` (the mean of the parent's), ``parent_ms_turns``."""
    if _parent_libs() is None:
        return {"ms": timer(fn)}
    with _parent_kernels():
        p1 = timer(fn)
    c1, c2 = timer(fn), timer(fn)
    with _parent_kernels():
        p2 = timer(fn)
    return {"ms": c1, "ms_turns": [c1, c2], "parent_ms": (p1 + p2) / 2,
            "parent_ms_turns": [p1, p2]}


# -- the draws' kernel ----------------------------------------------------------

# The entry points at the 1M paths' shapes: the drop legs at 1M (3
# gossip legs, 2 push/pull legs; asym_loss's hash partition at p_ab 0.6,
# p_ba 0, partition_heal's halves at 1: the nemesis main path's draw a
# round, ``main``); the Feistel targets at 1M; the shapes of the probe
# tick's former draws (B = 200,000 probers and their 3 helpers, the
# direct probes' losses, the degraded observers' misses at p 0.3), whose
# hash the probe tick's own kernel now runs inline.  Then odd and small
# lengths: 1, 4,099, 3,200 a row of 3, one past the grid's cap of 1,056
# blocks of 256 (threads stride), 16,001 columns.
DRAW_N, DRAW_B = 1_000_000, 200_000
DRAWS = (
    dict(entry="uniform", shape=(DRAW_B,)),
    dict(entry="uniform", shape=(DRAW_B, 3)),
    dict(entry="uniform", shape=(1,)),
    dict(entry="uniform", shape=(4_099,)),
    dict(entry="uniform", shape=(3_200, 3)),
    dict(entry="uniform", shape=(1_056 * 256 + 3,)),
    dict(entry="below", shape=(DRAW_B,), p=0.3),
    dict(entry="below", shape=(DRAW_B,), p=1.0 - 0.99 * 0.99),  # loss 0.01
    dict(entry="below", shape=(DRAW_B, 3), p=0.3),
    dict(entry="below", shape=(4_099,), p=2.0**-24),
    dict(entry="rows", shape=(3, DRAW_N)),
    dict(entry="rows", shape=(2, DRAW_N)),
    dict(entry="rows", shape=(3, 16_001)),
    dict(entry="edge_drops", shape=(3, DRAW_N), groups="hash", p_ab=0.6,
         p_ba=0.0),
    dict(entry="edge_drops", shape=(3, DRAW_N), groups="half", p_ab=1.0,
         p_ba=1.0, main=True),
    dict(entry="edge_drops", shape=(2, DRAW_N), groups="hash", p_ab=0.6,
         p_ba=0.0),
    dict(entry="edge_drops", shape=(3, 16_001), groups="hash", p_ab=0.3,
         p_ba=0.45),
    dict(entry="randint", shape=(DRAW_N,), minval=0, maxval=DRAW_N - 1),
    dict(entry="randint", shape=(7,), minval=-500, maxval=499),
    dict(entry="randint", shape=(4_099,), minval=1, maxval=16_000),
    dict(entry="bits", shape=(DRAW_N,)),
    dict(entry="bits", shape=(4_099,)),
)
# The sass mode whose loop each entry point runs (the edge drops hash
# their uncertain edges as the uniform draws an element: a hash and its
# float, compared with p).
DRAW_SASS_MODE = {"bits": "bits", "uniform": "uniform", "rows": "uniform",
                  "below": "below", "randint": "randint",
                  "edge_drops": "uniform"}


def _draw_keys(seed: int, count: int) -> list:
    """``count`` keys: fold_in chains of one seed, and two whose words have
    the high bit set."""
    from consul_tpu_torch import prng
    return ([np.asarray([0x80000000, 0xFFFFFFFF], np.uint32),
             np.asarray([0xDEADBEEF, 0x80000001], np.uint32)]
            + [prng.fold_in(prng.key(seed), i) for i in range(count - 2)])


def _draw_groups(kind: str, n: int) -> torch.Tensor:
    """A partition's groups on the card: the catalog's hash or halves."""
    ids = torch.arange(n, dtype=torch.int64, device="cuda")
    if kind == "hash":
        return (((ids * 2654435761) & 0xFFFFFFFF) >> 31).to(torch.int32)
    return (ids >= n // 2).to(torch.int32)


def _draw_fns(spec: dict, k):
    """(kernel call, plain call) of the draw ``spec`` under key ``k``, on
    the card; edge drops also return how many elements need a hash."""
    from consul_tpu_torch import prng
    e, shape = spec["entry"], spec["shape"]
    if e == "uniform":
        return (lambda: prng.uniform_tensor(k, shape, "cuda"),
                lambda: prng.uniform_ref(k, shape, "cuda"))
    if e == "below":
        return (lambda: prng.below(k, shape, spec["p"], "cuda"),
                lambda: prng.below_ref(k, shape, spec["p"], "cuda"))
    if e == "randint":
        lo, hi = spec["minval"], spec["maxval"]
        return (lambda: prng.randint_tensor(k, shape, lo, hi, "cuda"),
                lambda: prng.randint_ref(k, shape, lo, hi, "cuda"))
    if e == "bits":
        return (lambda: prng.random_bits_tensor(k, shape, "cuda"),
                lambda: prng.random_bits_ref(k, shape, "cuda"))
    rows, n = shape
    keys = [prng.fold_in(k, f) for f in range(rows)]
    if e == "rows":
        return (lambda: prng.uniform_rows(keys, n, "cuda"),
                lambda: prng.uniform_rows_ref(keys, n, "cuda"))
    args = _edge_args(spec, keys, k)
    return (lambda: prng.edge_drops(*args), lambda: prng.edge_drops_ref(*args))


def _device_words(keys) -> torch.Tensor:
    """Keys as a round's table row holds them: int32 words on the card."""
    words = np.asarray(keys, np.uint32).reshape(-1, 2).view(np.int32)
    return torch.from_numpy(words.copy()).cuda()


def _draw_dev_fn(spec: dict, k):
    """The draw ``spec`` under key ``k`` through the kernel's device-key
    entry point (the round's: keys, and the edge drops' shifts, read from
    memory, put on the card once here), or None for the entry points the
    round does not call."""
    from consul_tpu_torch import prng
    e, shape = spec["entry"], spec["shape"]
    if e in ("uniform", "below"):
        dk = _device_words([k])[0]
        if e == "uniform":
            return lambda: prng.uniform_tensor(dk, shape, "cuda")
        return lambda: prng.below(dk, shape, spec["p"], "cuda")
    if e not in ("rows", "edge_drops"):
        return None
    rows, n = shape
    keys = [prng.fold_in(k, f) for f in range(rows)]
    dk = _device_words(keys)
    if e == "rows":
        return lambda: prng.uniform_rows(dk, n, "cuda")
    _, grp, shifts, p_ab, p_ba = _edge_args(spec, keys, k)
    d_shifts = torch.tensor([int(o) for o in shifts], dtype=torch.int32,
                            device="cuda")
    return lambda: prng.edge_drops(dk, grp, d_shifts, p_ab, p_ba)


def _edge_args(spec: dict, keys: list, k):
    """The edge drops' arguments: the spec's groups (the group vector a
    path gave, ``grp``, or a catalog kind), shifts drawn from the key's
    words (two legs: o and -o, as push/pull's)."""
    rows, n = spec["shape"]
    o = np.random.default_rng(int(k[1])).integers(1, n, rows).tolist()
    shifts = [o[0], -o[0]] if rows == 2 else o
    grp = spec["grp"] if "grp" in spec else _draw_groups(spec["groups"], n)
    return keys, grp, shifts, spec["p_ab"], spec["p_ba"]


def _draw_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest difference of the two draws' bit patterns (0: equal)."""
    if got.shape != want.shape:
        raise AssertionError(f"shapes {list(got.shape)} != "
                             f"{list(want.shape)}")
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    a = got.to(torch.int64) & 0xFFFFFFFF
    b = want.to(torch.int64) & 0xFFFFFFFF
    return int((a - b).abs().max()) if a.numel() else 0


def _elements(spec: dict, k) -> int:
    """Elements of the draw under key ``k`` that run the hash: all of
    them, but for the edge drops only the cross-group edges of a
    direction whose probability lies strictly between 0 and 1."""
    if spec["entry"] != "edge_drops":
        return int(np.prod(spec["shape"]))
    _, grp, shifts, p_ab, p_ba = _edge_args(spec, [], k)
    total = 0
    for o in shifts:
        g_src = torch.roll(grp, o)
        p = torch.where(g_src == 0, p_ab, p_ba)
        total += int(((g_src != grp) & (p > 0) & (p < 1)).sum())
    return total


def _draw_bound(spec: dict, k, out: torch.Tensor, sass: dict) -> dict:
    """The least time the card could take for the draw: its output bytes
    (and the group vector's, for the edge drops) over the memory rate, or
    the operations of the elements that run the hash (the SASS count of
    the busiest unit per element of the entry point's loop) over the
    INT32 rate."""
    nbytes = out.numel() * out.element_size()
    if spec["entry"] == "edge_drops":
        nbytes += 4 * spec["shape"][1]
    per = sass[DRAW_SASS_MODE[spec["entry"]]]["busiest_unit_per_element"]
    elements = _elements(spec, k)
    ops = elements * per
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "hashed_elements": elements,
            "operations_per_element": per, "operations": ops,
            "operations_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def threefry_phase(card_line: str, keys: int = 16) -> dict:
    """Every entry point of the draws' kernel against its plain version on
    the card, at the paths' shapes and odd lengths, over ``keys`` keys
    (4 at 1M elements), bit for bit; per shape the kernel's time (CUDA
    graph replays, ``ms``, keys read from device memory where the round's
    draws take them so, else by value, ``by_value_ms`` beside it;
    back-to-back wrapper calls, ``eager_ms``), the
    plain version's (``plain_ms``, eager; at the main path's shapes also
    ``plain_graph_ms``), the bound and the share."""
    from consul_tpu_torch import prng, sass_count
    t0 = time.perf_counter()
    sass = sass_count.threefry_counts(sass_count.disassemble("threefry"))
    emit({"phase": "threefry_sass",
          **{m: {k: v for k, v in c.items() if k != "by_opcode"}
             for m, c in sass.items()}})
    rows, err = [], 0
    for i, spec in enumerate(DRAWS):
        big = int(np.prod(spec["shape"])) >= DRAW_N
        ks = _draw_keys(1000 + i, 4 if big else keys)
        for k in ks:
            kern, plain = _draw_fns(spec, k)
            want = plain()
            e = _draw_err(kern(), want)
            dev = _draw_dev_fn(spec, k)
            if dev is not None:
                e = max(e, _draw_err(dev(), want))
            if e != 0:
                raise AssertionError(f"threefry {spec['entry']} != plain at "
                                     f"{list(spec['shape'])}, key "
                                     f"{k.tolist()}: max abs err {e}")
            err = max(err, e)
        kern, plain = _draw_fns(spec, ks[-1])
        out = kern()
        # The round's draws take their keys from device memory: where the
        # entry point has that route, ``ms`` times it (the launch the paths
        # make) and ``by_value_ms`` the keys-by-value launch.
        dev = _draw_dev_fn(spec, ks[-1])
        timed = kern if dev is None else dev
        if _parent_libs() is not None:
            with _parent_kernels():
                e = _draw_err(timed(), plain())
            if e != 0:
                raise AssertionError(f"the parent's threefry "
                                     f"{spec['entry']} != plain at "
                                     f"{list(spec['shape'])}: {e}")
        row = {"entry": spec["entry"], "shape": list(spec["shape"]),
               "keys_held": len(ks),
               "keys": "by_value" if dev is None else "device",
               **_turns(timed, graph_ms), "eager_ms": cuda_ms(timed, 200),
               "plain_ms": cuda_ms(plain, 5, warm=1),
               **_draw_bound(spec, ks[-1], out, sass)}
        if dev is not None:
            row["by_value_ms"] = graph_ms(kern)
        row.update({k: spec[k] for k in ("p", "p_ab", "p_ba", "groups",
                                         "minval", "maxval") if k in spec})
        if spec.get("main"):
            row["main_path"] = True
            row["plain_graph_ms"] = graph_ms(plain, per_graph=5, replays=4)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        emit({"phase": "threefry", **row, "card": card_line})
    main = [r for r in rows if r.get("main_path")]
    res = {"phase": "threefry_summary", "tolerance": 0, "max_abs_err": err,
           "shapes": len(rows), "launches_held": sum(r["keys_held"]
                                                     for r in rows),
           "main_path_ms": sum(r["ms"] for r in main),
           "main_path_by_value_ms": sum(r["by_value_ms"] for r in main),
           "main_path_plain_ms": sum(r["plain_ms"] for r in main),
           "main_path_plain_graph_ms": sum(r["plain_graph_ms"]
                                           for r in main),
           "main_path_bound_ms": sum(r["bound_ms"] for r in main),
           "main_path_parent_ms": (sum(r["parent_ms"] for r in main)
                                   if _parent_libs() is not None else None),
           "main_path_bound_by": (
               "operations" if sum(r["operations_ms"] for r in main)
               >= sum(r["bytes_ms"] for r in main) else "bytes"),
           "seconds": time.perf_counter() - t0, "card": card_line}
    emit(res)
    prng.launch_shapes.clear()
    prng.launch_groups.clear()
    return {"summary": res, "rows": rows, "sass": sass}


def _spec_of_launch(shape: tuple) -> dict:
    """The ``DRAWS``-style spec of a launch shape the wrappers recorded
    (``prng.launch_shapes``); an edge-drops launch takes the group vector
    the path gave it (``prng.launch_groups``)."""
    from consul_tpu_torch import prng
    e, dims = shape[0], shape[1]
    if e == "bits":
        return dict(entry=e, shape=dims)
    if e == "uniform":
        return dict(entry="rows" if shape[2] > 1 else e, shape=dims)
    if e == "below":
        return dict(entry=e, shape=dims, p=shape[2])
    if e == "randint":
        return dict(entry=e, shape=dims, minval=shape[2], maxval=shape[3])
    return dict(entry=e, shape=dims, grp=prng.launch_groups[shape[4]],
                p_ab=shape[2], p_ba=shape[3])


def draw_shapes_vs_plain(shapes: set) -> list:
    """Every shape the paths launched the draws' kernel at, with 4 fresh
    keys against the plain version on the card; tolerance 0."""
    rows = []
    for i, shape in enumerate(sorted(shapes, key=repr)):
        spec = _spec_of_launch(shape)
        for k in _draw_keys(3000 + i, 4):
            kern, plain = _draw_fns(spec, k)
            e = _draw_err(kern(), plain())
            if e != 0:
                raise AssertionError(f"threefry at the path shape {shape} "
                                     f"!= plain: max abs err {e}")
        rows.append({"kernel": "threefry", "entry": spec["entry"],
                     "shape": list(spec["shape"]), "launches_held": 4})
    return rows


def adversarial(S: int, N: int, seed: int, dev):
    """Every byte value (message, confirmation count and age, the fresh
    sentinel included), senders dead/alive/non-member, receivers on and
    off, caps 0..3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    heard = torch.randint(0, 256, (S, N), generator=g, device=dev,
                          dtype=torch.uint8)
    choices = torch.tensor([-1, 10, 200, NEVER], dtype=torch.int32,
                           device=dev)
    mf = choices[torch.randint(0, 4, (N,), generator=g, device=dev)]
    rx_ok = torch.rand(N, generator=g, device=dev) < 0.9
    cap = torch.randint(0, 4, (S,), generator=g, device=dev,
                        dtype=torch.int32)
    return heard, mf, rx_ok, cap


def flood_sass() -> dict:
    """The event flood's slot loop at fanouts 3 and 4, per execution unit
    (``sass_count.py --flood``): what the kernel runs a word, shown beside
    the flood's bound, which is counted from the rule."""
    from consul_tpu_torch import sass_count
    sass = sass_count.disassemble("event_flood")
    out = {}
    for F in (3, 4):
        try:
            out[F] = sass_count.row_loop_counts(sass, F, "flood_kernel")
        except RuntimeError as e:  # a count that cannot be taken bounds nothing
            out[F] = {"error": str(e)}
    return out


def sass_phase() -> dict:
    """The SASS count of the tail's word path's row loop at fanout 3, per
    execution unit (consul_tpu_torch/sass_count.py), for the operations
    bound; under ``flood``, the event flood's (``flood_sass``)."""
    from consul_tpu_torch import sass_count
    res = sass_count.row_loop_counts(sass_count.disassemble(), 3)
    res["flood"] = flood_sass()
    emit({"phase": "sass", **res})
    return res


def _bound(S: int, N: int, F: int, sass: dict, drop: bool = False) -> dict:
    """The least time the card could take for the tail at [S, N] and
    fanout F (with a drop operand: ``drop``): the bytes it must move over
    the memory rate, or its integer operations over the INT32 rate of the
    busiest unit, whichever is larger."""
    # heard read once, out written once; mf (int32), rx (1 byte) and cap
    # (int32) read once; a drop operand's F bytes per column read once.
    nbytes = 2 * S * N + 5 * N + 4 * S + (F * N if drop else 0)
    # The per-byte rule's operations, counted from disseminate_ref: 10 to
    # age the current byte, 18 per leg (age the pin, gate it, priority-max,
    # count suspects), 22 to merge and pack; plus one sender-liveness
    # compare per leg and column.
    nops = S * N * (32 + 18 * F) + N * F
    # Four bytes to a 32-bit word: each counted operation covers a word.
    # Where the SASS of the word loop gives its busiest execution unit fewer
    # instructions per word than that (at fanout 3; one alignment way,
    # sass_count.py), the bound takes the SASS count.
    per_word = 32 + 18 * F
    if F == sass["fanout"] and sass["busiest_unit_per_word"] < per_word:
        per_word = sass["busiest_unit_per_word"]
    word_ops = S * N / 4 * per_word + N * F
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = word_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "byte_operations": nops,
            "operations_per_word": per_word, "word_operations": word_ops,
            "operations_ms": ops_ms, "int32_ops_per_s": INT32_OPS_PER_S,
            "operations_ms_at_int8_tensor_rate":
                nops / INT8_TENSOR_OPS_PER_S * 1e3,
            "int8_tensor_ops_per_s": INT8_TENSOR_OPS_PER_S,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _offset_sets(N: int, L: int, seed: int, F: int = 3) -> list:
    """Sets of F gossip shifts (N >= 4): first 1, N - 1 and random ones
    (the timed set); then, together, every residue mod 16 (2..17 and
    large shifts of each residue; below N = 48 every shift), and shifts
    above L (pins from a shard further on), the last set padded with
    random shifts."""
    rng = np.random.default_rng(seed)
    first = [1, N - 1] + [int(rng.integers(2, N - 1)) for _ in range(F - 2)]
    if N < 48:
        rest = list(range(2, N - 1))
    else:
        rest = list(range(2, 18)) + [
            int(rng.integers(1, (N - 16) // 16)) * 16 + r for r in range(16)]
    rest += [L + 1, 2 * L + 7, N - L - 3]
    rest += [int(rng.integers(1, N)) for _ in range(-len(rest) % F)]
    return [first] + [rest[k:k + F] for k in range(0, len(rest), F)]


def _held(name: str, shape, kern, plain) -> int:
    """Run the kernel and its plain version; raise unless byte-identical."""
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(out_k, torch.Tensor):
        out_k, out_p = (out_k,), (out_p,)
    err = max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
              for a, b in zip(out_k, out_p))
    if err != 0:
        n_bad = sum(int((a != b).sum()) for a, b in zip(out_k, out_p))
        raise AssertionError(f"{name} != plain at {shape}: {n_bad} bytes "
                             f"differ, max abs err {err}")
    return err


def _drops(N: int, F: int, seed: int):
    """Drop operands of the card's kernels: a random one (each byte set
    with probability 1/2, to any nonzero value), and the full bisection of
    ``partition_heal`` with its window open (every leg whose sender lies
    in the other half of the ids drops: ``drops(offs)``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = (torch.randint(1, 256, (F, N), generator=g, device="cuda",
                          dtype=torch.uint8)
            * (torch.rand((F, N), generator=g, device="cuda") < 0.5))
    grp = (torch.arange(N, device="cuda") >= N // 2)

    def bisection(offs):
        return torch.stack([torch.roll(grp, o) != grp for o in offs])
    return rand, bisection


def _drop_variants(N: int, sets, seed: int):
    """(offsets, drop) pairs: each offset set without a drop operand,
    with the random one and with the bisection."""
    rand, bisection = _drops(N, len(sets[0]), seed)
    return [(o, d) for o in sets
            for d in (None, rand[:len(o)], bisection(o))]


def _tail_args(rnd: int, sets) -> dict:
    """Each offset set's ``[rnd, o_0 ..]`` buffer on the card, as the
    tail reads it (made once, outside the timed captures)."""
    from consul_tpu_torch.gossip import fused
    return {tuple(o): fused.tail_args(rnd, o, "cuda") for o in sets}


def kernel_vs_plain(S: int, N: int, seed: int, sass: dict) -> dict:
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    heard, mf, rx_ok, cap = adversarial(S, N, seed, "cuda")
    rnd = 50
    budget = p.spread_budget_rounds
    sets = _offset_sets(N, N, seed)
    variants = _drop_variants(N, sets, seed)
    dargs = _tail_args(rnd, sets)

    def kern(offs=sets[0], drop=None):
        r, o = dargs[tuple(offs)]
        return fused.fused_dissem(heard, o, mf, rx_ok, cap, r, budget, drop)

    def plain(offs=sets[0], drop=None):
        r, o = dargs[tuple(offs)]
        return fused.disseminate_ref(p, r, o, heard, mf, rx_ok, cap, drop)

    err = max(_held("fused_dissem", [S, N], lambda: kern(o, d),
                    lambda: plain(o, d)) for o, d in variants)
    # Shifts given off by -N, which the kernel reduces.
    r_n, o_n = fused.tail_args(rnd, [o - N for o in sets[0]], "cuda")
    err = max(err, _held("fused_dissem", [S, N], lambda: fused.fused_dissem(
        heard, o_n, mf, rx_ok, cap, r_n, budget), plain))
    drop = variants[1][1]
    ms = graph_ms(kern)
    ms_drop = graph_ms(lambda: kern(sets[0], drop))
    eager_ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 5, warm=1)
    bound = _bound(S, N, len(sets[0]), sass)
    bound_drop = _bound(S, N, len(sets[0]), sass, drop=True)
    res = {"phase": "kernel", "shape": [S, N], "offsets": sets[0],
           "offset_sets_held": len(sets), "drop_variants_held": len(variants),
           "tolerance": 0, "max_abs_err": err, "ms": ms, "ms_drop": ms_drop,
           "eager_ms": eager_ms, "plain_ms": plain_ms, **bound,
           "bound_ms_drop": bound_drop["bound_ms"],
           "share_of_bound": bound["bound_ms"] / ms,
           "share_of_bound_drop": bound_drop["bound_ms"] / ms_drop,
           "library_ms": None}
    emit(res)
    return res


def merge_vs_plain(S: int, N: int, ndev: int, seed: int,
                   sass: dict) -> dict:
    """fused_merge (all shards, one launch) against merge_shards_ref on
    the card: the whole [S, N] matrix as ndev shards."""
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    L = N // ndev
    heard, mf, rx_ok, cap = adversarial(S, N, seed, "cuda")
    shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
    del heard
    sc = kernel._ShardCtx(ndev, L)
    rnd = 50
    budget = p.spread_budget_rounds
    sets = _offset_sets(N, L, seed)
    variants = _drop_variants(N, sets, seed)
    dargs = _tail_args(rnd, sets)

    def kern(offs=sets[0], drop=None):
        r, o = dargs[tuple(offs)]
        return fused.fused_merge(shards, o, mf, rx_ok, cap, r, budget, drop)

    def plain(offs=sets[0], drop=None):
        r, o = dargs[tuple(offs)]
        return fused.merge_shards_ref(p, r, o, shards, mf, rx_ok, cap, sc,
                                      drop)

    err = max(_held("fused_merge", [S, N, ndev], lambda: kern(o, d),
                    lambda: plain(o, d)) for o, d in variants)
    r_n, o_n = fused.tail_args(rnd, [o - N for o in sets[0]], "cuda")
    err = max(err, _held("fused_merge", [S, N, ndev], lambda: fused.fused_merge(
        shards, o_n, mf, rx_ok, cap, r_n, budget), plain))
    drop = variants[1][1]
    ms = graph_ms(kern)
    ms_drop = graph_ms(lambda: kern(sets[0], drop))
    eager_ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 5, warm=1)
    # The function is kernel 1's at [S, N]: its bytes and operations.
    bound = _bound(S, N, len(sets[0]), sass)
    bound_drop = _bound(S, N, len(sets[0]), sass, drop=True)
    res = {"phase": "merge_kernel", "shape": [S, N], "ndev": ndev, "L": L,
           "offsets": sets[0], "offset_sets_held": len(sets),
           "drop_variants_held": len(variants), "tolerance": 0,
           "max_abs_err": err, "ms": ms, "ms_drop": ms_drop,
           "eager_ms": eager_ms, "plain_ms": plain_ms, **bound,
           "bound_ms_drop": bound_drop["bound_ms"],
           "share_of_bound": bound["bound_ms"] / ms,
           "share_of_bound_drop": bound_drop["bound_ms"] / ms_drop,
           "library_ms": None}
    emit(res)
    return res


def repeat(S: int, N: int, seeds: int, ndev: int | None = None,
           launches: int = 3) -> dict:
    """``fused_dissem`` (or, with ``ndev``, ``fused_merge`` on ndev
    shards) against its plain version over ``seeds`` fresh inputs, each
    with its own random offset triple and, in turn, no drop operand, a
    random one and the bisection's, ``launches`` launches each: every
    launch must be byte-identical to the plain version."""
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    rnd, budget = 50, p.spread_budget_rounds
    L = N if ndev is None else N // ndev
    sc = None if ndev is None else kernel._ShardCtx(ndev, L)
    bad = held = 0
    t0 = time.perf_counter()
    for seed in range(seeds):
        heard, mf, rx_ok, cap = adversarial(S, N, 1000 + seed, "cuda")
        legs = [int(o) for o in
                np.random.default_rng(seed).integers(1, N, 3)]
        r, offs = fused.tail_args(rnd, legs, "cuda")
        drop = None
        if seed % 3:
            rand, bisection = _drops(N, 3, seed)
            drop = rand if seed % 3 == 1 else bisection(legs)
        if ndev is None:
            ref = (fused.disseminate_ref(p, r, offs, heard, mf, rx_ok,
                                         cap, drop),)
        else:
            heard = tuple(h.contiguous() for h in heard.split(L, dim=1))
            ref = fused.merge_shards_ref(p, r, offs, heard, mf, rx_ok,
                                         cap, sc, drop)
        for _ in range(launches):
            if ndev is None:
                out = (fused.fused_dissem(heard, offs, mf, rx_ok, cap, r,
                                          budget, drop),)
            else:
                out = fused.fused_merge(heard, offs, mf, rx_ok, cap, r,
                                        budget, drop)
            bad += sum(int((a != b).sum()) for a, b in zip(out, ref))
            held += 1
    res = {"phase": "repeat",
           "kernel": "fused_dissem" if ndev is None else "fused_merge",
           "shape": [S, N], "ndev": ndev, "seeds": seeds,
           "launches_held": held, "bytes_differing": bad,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if bad:
        raise AssertionError(f"{res['kernel']} != plain at {[S, N]} in "
                             f"{bad} bytes over {seeds} seeds")
    return res


# -- the event flood's kernel ----------------------------------------------------

# (E, N, fanout): the multi-DC LAN pool's [32, 250,000], the plane's
# [64, 1M], the WAN pool's [32, 12] at fanout 4, and odd N.
FLOOD_SHAPES = ((32, 250_000, 3), (64, 1_000_000, 3), (32, 12, 4),
                (64, 16_001, 3))
FLOOD_RND, FLOOD_TTL = 500, 40


def flood_inputs(E: int, N: int, seed: int, dev="cuda"):
    """Every byte value (a third of the bytes; the rest seen or not with
    every age, so ages lie at and across any budget), senders alive with
    holes, slots used or free with start rounds on both sides of the TTL
    at round ``FLOOD_RND``, Lamport times and clocks at the int32 edge,
    counts next to the 2**32 wrap."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(n, hi):
        return torch.randint(0, hi, (n,), generator=g, device=dev)

    def pick(values, n):
        v = torch.tensor(values, dtype=torch.int32, device=dev)
        return v[ints(n, len(values))]

    rand = torch.randint(0, 256, (E, N), generator=g, device=dev,
                         dtype=torch.uint8)
    aged = ((torch.rand((E, N), generator=g, device=dev) < 0.4).to(
        torch.uint8) * 0x80 | torch.randint(0, 16, (E, N), generator=g,
                                             device=dev, dtype=torch.uint8))
    has = torch.where(torch.rand((E, N), generator=g, device=dev) < 0.35,
                      rand, aged)
    alive = torch.rand(N, generator=g, device=dev) < 0.8
    used = torch.rand(E, generator=g, device=dev) < 0.8
    ltime = pick([-5, 0, 1, 7, 1000, NEVER], E)
    origin = (ints(E, N + 1) - 1).to(torch.int32)
    start = (FLOOD_RND - FLOOD_TTL + ints(E, 5) - 2).to(torch.int32)
    node_ltime = pick([-3, 0, 2, 999, NEVER - 1, NEVER], N)
    n_seen = pick([0, 5, NEVER - 2, -1, -2**31], E)
    return [has, alive, used, ltime, origin, start, node_ltime, n_seen]


def _flood_rows(N: int, F: int, seed: int) -> list:
    """Event rows ``[rnd, o_0 .., pp, -pp]``: shifts 1 and N - 1 with a
    random one, random sets, and the same sets off by -N (the kernel
    reduces them), each once with push/pull off and on."""
    rng = np.random.default_rng(seed)
    sets = []
    for k in range(3):
        offs = ([1, N - 1] + rng.integers(1, N, F).tolist())[:F] if k == 0 \
            else rng.integers(1, N, F).tolist()
        pp = int(rng.integers(1, N))
        sets.append((offs, pp))
        sets.append(([o - N for o in offs], pp - N))
    return [(torch.tensor([FLOOD_RND, *offs, pp, -pp], dtype=torch.int32,
                          device="cuda"), pushpull)
            for offs, pp in sets for pushpull in (False, True)]


def _flood_err(got, want) -> int:
    """The largest difference over every output of one flood (0 for
    equal), raising where any differs."""
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              if a.numel() else 0 for a, b in zip(got, want))
    if err:
        bad = [f for f, a, b in zip(got._fields, got, want)
               if not torch.equal(a, b)]
        raise AssertionError(f"event_flood != plain in {bad}, max abs err "
                             f"{err}")
    return err


def flood_ops_per_word(F: int) -> int:
    """The flood's integer operations a 32-bit word (four columns of one
    slot) at fanout F on a round without push/pull, counted by hand from
    the rule (``event_flood_ref``), not from any kernel: 8 a leg (the
    funnel shift that makes the pin word, the budget test's mask, or and
    subtract, its two shifts and and-not, the gate with the live senders,
    the or into new_seen) and 24 a word (2 the seen bits, 1 fresh, 10 to
    age and blend the bytes, 1 the slot's TTL, 6 the two counts' masks,
    popcounts and adds, 4 the witness's max on each column)."""
    return 8 * F + 24


def _flood_bound(E: int, N: int, F: int, sass: dict | None) -> dict:
    """The least time of one flood on the card (ms): the larger of its
    bytes (has read and written once, alive read, node_ltime read and
    written, the [E] registers, the live holders' counts among them, and
    the row) over the memory rate and its operations
    (``flood_ops_per_word`` for E N / 4 words) over the INT32 rate.  The
    kernel's own slot loop (``flood_sass``: the busiest unit's
    instructions a word) is shown beside it and bounds nothing."""
    bytes_ = 2 * E * N + N + 8 * N + 30 * E + 4 * (F + 3)
    per_word = flood_ops_per_word(F)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = E * N / 4 * per_word / INT32_OPS_PER_S * 1e3
    return {"bytes": bytes_, "bytes_ms": bytes_ms,
            "operations_per_word": per_word, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "kernel_sass_busiest_unit_per_word":
                (sass or {}).get(F, {}).get("busiest_unit_per_word")}


def _flood_into(ins, E: int, N: int):
    """Outputs and a scratch for ``event_flood`` at [E, N], made once, as
    the event program keeps them: a launch with them is the one kernel
    node of a replayed round."""
    from consul_tpu_torch.gossip import events
    has, _, used, _, origin, _, node_ltime, n_seen = ins
    out = events.Flood(*(torch.empty_like(t) for t in (
        has, used, origin, node_ltime, n_seen, n_seen)))
    return out, events.flood_scratch(E, N, has.device)


def flood_phase(card_line: str, sass: dict | None, seeds: int = 64) -> dict:
    """``event_flood`` (``csrc/event_flood.cu``) against ``event_flood_ref``
    on the card, tolerance 0 in every output (has, slot_used, origin,
    node_ltime, n_seen, the live holders), at ``FLOOD_SHAPES`` over
    ``_flood_rows`` and budgets 1, 3 and 14; its time in CUDA-graph
    replays (the row read from device memory), as the event program
    launches it (outputs and scratch kept: one kernel node) and through
    the wrapper alone (new outputs, a memset of the scratch), beside the
    bound (``_flood_bound``; ``sass``: ``flood_sass``, or None) and the
    plain version's time; then [32, 250,000] over ``seeds`` fresh inputs,
    push/pull off and on."""
    from consul_tpu_torch.gossip import events
    from consul_tpu_torch.gossip.params import lan_profile

    t0 = time.perf_counter()
    rows, err, held = {}, 0, 0
    for i, (E, N, F) in enumerate(FLOOD_SHAPES):
        ins = flood_inputs(E, N, 500 + i)
        for j, (row, pp) in enumerate(_flood_rows(N, F, 600 + i)):
            budget = (1, 3, 14)[j % 3]
            want = events.event_flood_ref(*ins, row, budget, FLOOD_TTL, pp)
            err = max(err, _flood_err(events.event_flood(
                *ins, row, budget, FLOOD_TTL, pp), want))
            held += 1
        budget = lan_profile(N).spread_budget_rounds
        out, scratch = _flood_into(ins, E, N)
        row0, row1 = _flood_rows(N, F, 700)[0][0], _flood_rows(N, F, 700)[1][0]

        def kernel_ms(row, pp):
            return graph_ms(lambda: events.event_flood(
                *ins, row, budget, FLOOD_TTL, pp, out=out, scratch=scratch))

        ms = kernel_ms(row0, False)
        wrapper_ms = graph_ms(lambda: events.event_flood(
            *ins, row0, budget, FLOOD_TTL, False))
        ms_pp = kernel_ms(row1, True)
        plain_ms = cuda_ms(lambda: events.event_flood_ref(
            *ins, row0, budget, FLOOD_TTL, False),
            iters=5 if N >= 250_000 else 20)
        bound = _flood_bound(E, N, F, sass)
        rows[f"{E}x{N}"] = {"shape": [E, N], "fanout": F, "budget": budget,
                            "ms": ms, "ms_pushpull": ms_pp,
                            "ms_wrapper": wrapper_ms,
                            "plain_ms": plain_ms, **bound,
                            "share_of_bound": bound["bound_ms"] / ms}
        del ins, out, scratch
    # Many seeds at the multi-DC LAN pool's shape.
    E, N, F = FLOOD_SHAPES[0]
    for seed in range(seeds):
        ins = flood_inputs(E, N, 2000 + seed)
        rng = np.random.default_rng(seed)
        offs, pp = rng.integers(1, N, F).tolist(), int(rng.integers(1, N))
        row = torch.tensor([FLOOD_RND, *offs, pp, -pp], dtype=torch.int32,
                           device="cuda")
        for pushpull in (False, True):
            err = max(err, _flood_err(
                events.event_flood(*ins, row, 4, FLOOD_TTL, pushpull),
                events.event_flood_ref(*ins, row, 4, FLOOD_TTL, pushpull)))
            held += 1
    torch.cuda.empty_cache()
    res = {"phase": "event_flood", "card": card_line, "tolerance": 0,
           "max_abs_err": err, "launches_held": held, "seeds": seeds,
           "shapes": rows, "library_ms": None,
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def flood_shapes_vs_plain(shapes: set) -> list:
    """Every (E, N, F, budget, ttl, push/pull) the paths launched the
    flood at (``events.launch_shapes``), on fresh inputs under four rows
    (shifts off by -N among them) against the plain version."""
    from consul_tpu_torch.gossip import events

    rows = []
    for i, (E, N, F, budget, ttl, pp) in enumerate(sorted(shapes)):
        ins = flood_inputs(E, N, 900 + i)
        for row, _ in _flood_rows(N, F, 950 + i)[:8:2]:
            _flood_err(events.event_flood(*ins, row, budget, ttl, pp),
                       events.event_flood_ref(*ins, row, budget, ttl, pp))
        rows.append({"kernel": "event_flood", "shape": [E, N], "fanout": F,
                     "budget": budget, "ttl": ttl, "pushpull": pp,
                     "launches_held": 4})
    return rows


# -- the observers' kernel ------------------------------------------------------

# (R, N, ndev) where the paths count: the 1M round's final matrix, a
# multi-DC LAN pool, the byte path (N % 4 != 0), the multi-DC LAN pool on
# 8 shards of 31,250 (L % 16 == 2: the byte path across shards), the 1M
# round on 8 shards of 125,000, the hot tier's gathered rows at 1M.
OBSERVE_SHAPES = ((64, 1_000_000, 1), (32, 250_000, 1), (64, 16_001, 1),
                  (64, 250_000, 8), (64, 1_000_000, 8), (8, 1_000_000, 1))
OBSERVE_BUDGET = 6  # lan_profile's spread budget at 4,000 to 1M nodes


def observe_ops_per_word(form: str = "final") -> float:
    """The counts' integer operations a 32-bit word (four columns of one
    row) in ``form`` (``final``: dead, refute and live; ``spread``: the
    holders), counted by hand from the rule of ``csrc/observe.cu`` in
    instruction slots, a three-input logic op (LOP3) or add (IADD3) being
    one slot, constants held in registers.  The final matrix's form: 2
    shifts (the word by 6 and by 7: the message's bits at each byte's bit
    0), 1 each for DEAD and REFUTE (one LOP3 of the two and the member
    byte), 5 for a live rumor (the age's mask-and-or in one LOP3, the
    budget's subtract, a shift, two LOP3s of the bits, the age test and the
    byte mask), 1.5 to add three flags (IADD3s) and 0.75 for the sums
    across the bytes (a multiply and a shift a count, every 8 words of a
    row): 11.25.  The spread's: a shift, the verdict's XOR, a shift and one
    LOP3 with the member byte, 0.5 to add, 0.25 for the byte sum: 4.75."""
    if form == "spread":
        return 1 + 1 + 1 + 1 + 0.5 + 0.25
    return 2 + 1 + 1 + 5 + 1.5 + 0.75


def observe_sass() -> dict:
    """Each form's row loop of ``csrc/observe.cu`` per execution unit
    (``sass_count.py --observe``: the cheapest path, a row on the aligned
    path), or the reason it could not be counted."""
    from consul_tpu_torch import sass_count
    out = {}
    forms = getattr(sass_count, "OBSERVE_FORMS", ())  # none in an A/B's parent
    try:
        sass = sass_count.disassemble("observe")
    except RuntimeError as e:  # a count that cannot be taken bounds nothing
        return {f: {"error": str(e)} for f in forms}
    for form in forms:
        try:
            out[form] = sass_count.observe_counts(sass, form)
        except RuntimeError as e:
            out[form] = {"error": str(e)}
    return out


def _observe_bound(R: int, N: int, rows_read: int, form: str = "final",
                   sass: dict | None = None) -> dict:
    """The least time of one launch in ``form`` that reads ``rows_read``
    of its ``R`` rows (ms): the larger of its bytes (those rows and member
    read once, the spread's verdict and want rows read, the counts
    written) over the memory rate and its operations over the INT32 rate:
    ``observe_ops_per_word(form)`` for the words of the rows it reads, or
    the SASS count's busiest unit (``observe_sass``) where that is
    fewer."""
    per_word = observe_ops_per_word(form)
    got = (sass or {}).get(form, {}).get("busiest_unit_per_word")
    if got is not None and got < per_word:
        per_word = got
    bytes_ = (rows_read * N + (N if rows_read else 0)
              + (5 * R if form == "spread" else 0) + 16 * R)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = rows_read * N / 4 * per_word / INT32_OPS_PER_S * 1e3
    return {"bytes": bytes_, "bytes_ms": bytes_ms,
            "operations_per_word": per_word,
            "operations_per_word_by_hand": observe_ops_per_word(form),
            "operations_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _observe_inputs(R: int, N: int, ndev: int, seed: int):
    """Every byte value, member with holes, verdicts DEAD and REFUTE (and
    one out of range), a want mask with holes; the matrix as ``ndev``
    column shards (the tensor itself at 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    heard = torch.randint(0, 256, (R, N), device="cuda", dtype=torch.uint8,
                          generator=g)
    if R > 2:
        heard[1] = 0
        heard[2] = (2 << 6) | (heard[2] & 0x3F)
    member = torch.rand(N, device="cuda", generator=g) < 0.9
    verdict = 2 + (torch.rand(R, device="cuda", generator=g) < 0.5).to(
        torch.int32)
    verdict[0] = -1
    want = torch.rand(R, device="cuda", generator=g) < 0.5
    L = N // ndev
    arg = heard if ndev == 1 else tuple(
        heard[:, i * L:(i + 1) * L].contiguous() for i in range(ndev))
    return arg, member, verdict, want


def _observe_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest difference of two launches' counts; raises unless 0."""
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err or got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"heard_counts != plain, max abs err {err}")
    return err


# The spread's wanted rows of the forms the round launches at 1M: one
# slot recycled, three (rows whose verdicts _observe_inputs makes DEAD or
# REFUTE).
OBSERVE_FEW = {1: (5,), 3: (5, 17, 40)}


def _observe_forms(R: int, N: int, verdict, want, none) -> dict:
    """form name -> (verdict, want, rows read) of the forms timed at a
    shape: the final matrix's (every row), the spread's with ``want`` and
    with no row; at [64, 1M], also the spread's with 1 and 3 rows."""
    forms = {"": (None, None, R),
             "_spread": (verdict, want, int((want & (verdict >= 0)
                                             & (verdict <= 3)).sum())),
             "_no_row": (verdict, none, 0)}
    if (R, N) == (64, 1_000_000):
        for k, rows in OBSERVE_FEW.items():
            forms[f"_spread_{k}"] = (verdict, _few_wanted(want, rows), k)
    return forms


def _few_wanted(want, rows):
    w = torch.zeros_like(want)
    w[list(rows)] = True
    return w


def observe_phase(card_line: str, seeds: int = 64) -> dict:
    """``heard_counts`` (``csrc/observe.cu``) against ``heard_counts_ref``
    on the card, tolerance 0 in every count, at ``OBSERVE_SHAPES`` over
    ``seeds`` fresh inputs each, in the forms the round launches it: the
    final matrix (every row, no verdict: the trace's holders and the
    flight row's rumors), the spread (a verdict, ``want`` with holes) and
    a spread with no row wanted; budgets 0 to 16 on the first seed; at
    [64, 1M] also the spread with 1 and 3 rows wanted (``OBSERVE_FEW``) on
    the first 8 seeds.  Each form's time in CUDA-graph replays (20
    launches a graph), the plain version's, and the bound
    (``_observe_bound``, with the SASS counts of ``observe_sass``)."""
    from consul_tpu_torch.gossip import observe

    t0 = time.perf_counter()
    sass = observe_sass()
    rows, err, held = {}, 0, 0
    for R, N, ndev in OBSERVE_SHAPES:
        for seed in range(seeds):
            arg, member, verdict, want = _observe_inputs(R, N, ndev,
                                                         1000 * R + seed)
            none = torch.zeros_like(want)
            budgets = (0, 1, 3, 6, 14, 16) if seed == 0 else (OBSERVE_BUDGET,)
            forms = [(None, None), (verdict, want), (verdict, none)]
            if seed < 8 and (R, N) == (64, 1_000_000):
                forms += [(verdict, _few_wanted(want, rows))
                          for rows in OBSERVE_FEW.values()]
            for budget in budgets:
                for v, w in forms:
                    err = max(err, _observe_err(
                        observe.heard_counts(arg, member, budget, v, w),
                        observe.heard_counts_ref(arg, member, budget, v, w)))
                    held += 1
        arg, member, verdict, want = _observe_inputs(R, N, ndev, 7)
        none = torch.zeros_like(want)
        b = OBSERVE_BUDGET
        sc = observe.counts_scratch(R, "cuda")  # as a round program's
        key = f"{R}x{N}" + (f"/{ndev}" if ndev > 1 else "")
        row = {"shape": [R, N], "ndev": ndev, "L": N // ndev, "budget": b}
        for name, (v, w, read) in _observe_forms(R, N, verdict, want,
                                                 none).items():
            ms = graph_ms(lambda: observe.heard_counts(arg, member, b, v, w,
                                                       sc))
            bound = _observe_bound(R, N, read,
                                   "final" if v is None else "spread", sass)
            row[f"ms{name}"] = ms
            row[f"rows_read{name}"] = read
            row[f"bound_ms{name}"] = bound["bound_ms"]
            row[f"share_of_bound{name}"] = bound["bound_ms"] / ms
            if not name:
                row.update(bound)
        row["plain_ms"] = cuda_ms(
            lambda: observe.heard_counts_ref(arg, member, b),
            iters=5 if N >= 250_000 else 20)
        row["plain_ms_spread"] = cuda_ms(
            lambda: observe.heard_counts_ref(arg, member, b, verdict, want),
            iters=5 if N >= 250_000 else 20)
        rows[key] = row
        if int(sc.abs().sum()):
            raise AssertionError(f"heard_counts left its scratch non-zero "
                                 f"at {key}")
        del arg, member, verdict, want, none
    torch.cuda.empty_cache()
    res = {"phase": "observe", "card": card_line, "tolerance": 0,
           "max_abs_err": err, "launches_held": held, "seeds": seeds,
           "shapes": rows, "sass": sass, "library_ms": None,
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def observe_shapes_vs_plain(shapes: set) -> list:
    """Every (R, L, ndev, budget, verdict, want) the paths launched the
    counts at (``observe.launch_shapes``), on fresh inputs in that form
    against the plain version."""
    from consul_tpu_torch.gossip import observe

    rows = []
    for i, (R, L, ndev, budget, has_v, has_w) in enumerate(sorted(shapes)):
        for seed in range(4):
            arg, member, verdict, want = _observe_inputs(R, L * ndev, ndev,
                                                         5000 + 10 * i + seed)
            v = verdict if has_v else None
            w = want if has_w else None
            _observe_err(observe.heard_counts(arg, member, budget, v, w),
                         observe.heard_counts_ref(arg, member, budget, v, w))
        rows.append({"kernel": "heard_counts", "shape": [R, L * ndev],
                     "ndev": ndev, "L": L, "budget": budget,
                     "verdict": has_v, "want": has_w, "launches_held": 4})
    return rows


# -- the finish step's passes: the fire pass and the row wipes ------------------

# The 1M round's matrix, a multi-DC LAN pool's, odd N (N % 16 == 1), 8
# shards of 31,250 (a sharded multi-DC pool's, L % 16 == 2), the hot
# tier's gathered rows at 1M, 8 shards of 125,000 (the sharded 1M round's,
# L % 16 == 8).
FINISH_SHAPES = ((64, 1_000_000, 1), (32, 250_000, 1), (64, 16_001, 1),
                 (64, 250_000, 8), (8, 1_000_000, 1), (64, 1_000_000, 8))
# Rows whose timer can fire in a usual 1M churn round (a slot or two at
# the end of its suspicion), and rows a round wipes.
FINISH_FEW = 2


def finish_ops_per_word() -> int:
    """The fire rule's integer operations a 32-bit word (four columns of
    one row), counted by hand from ``csrc/finish.cu``'s ``fire_word`` in
    instruction slots, a three-input logic op (LOP3) being one slot, the
    rule one table lookup a byte: 1 shift of each byte's top nibble down,
    1 LOP3 to mask it and add the no-rx bit, 1 to join each half's two
    nibbles, 1 byte permute to pack them into the lookup's selector, 1 byte
    permute for the lookup, 1 shift and 1 LOP3 to write DEAD where it
    fired, 1 for the row's fired flag and 1 to compare the word with what
    was read: 9."""
    return 1 + 1 + 1 + 1 + 1 + 2 + 1 + 1


def _finish_bound(R: int, N: int, read_rows: int, written: int,
                  rx: bool = True) -> dict:
    """The least time of one launch (ms) that reads ``read_rows`` rows of
    N bytes and writes ``written`` bytes of the matrix: the larger of its
    bytes (those, rx read once where a row is read, the R row arguments:
    one byte each for the wipe, ok, the refutation's column and byte and
    fired for the fire) over the memory rate and its operations
    (``finish_ops_per_word`` for the words of the rows read) over the
    INT32 rate."""
    args = 7 * R if rx else R
    bytes_ = (read_rows * N + written + (N if rx and read_rows else 0)
              + args)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = (read_rows * N / 4 * finish_ops_per_word()
              / INT32_OPS_PER_S * 1e3)
    return {"bytes": bytes_, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _finish_inputs(R: int, N: int, seed: int):
    """Every byte value, rx with holes, the timer masks of every row
    (1-15), of ``FINISH_FEW`` rows and of none, the refutation's columns
    (the shards' first and last columns among them) and bytes (0xC0 on
    about a third of the rows), and wipe flags on ``FINISH_FEW`` rows
    (the last among them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    heard = torch.randint(0, 256, (R, N), device="cuda", dtype=torch.uint8,
                          generator=g)
    rx = torch.rand(N, device="cuda", generator=g) < 0.9
    ok_all = torch.randint(1, 16, (R,), device="cuda", dtype=torch.uint8,
                           generator=g)
    few = torch.zeros(R, dtype=torch.bool, device="cuda")
    few[torch.randperm(R, device="cuda", generator=g)[:FINISH_FEW]] = True
    ok_few = torch.where(few, ok_all, 0).to(torch.uint8)
    col = torch.randint(0, N, (R,), device="cuda", dtype=torch.int32,
                        generator=g)
    col[:2] = torch.tensor([N - 1, 0], dtype=torch.int32)
    rb = torch.where(torch.rand(R, device="cuda", generator=g) < 0.35,
                     0xC0, 0).to(torch.uint8)
    flags = few.clone()
    flags[-1] = True
    return heard, rx, ok_all, ok_few, (col, rb), flags


def _split_rows(heard: torch.Tensor, ndev: int, offset: int = 0):
    """The matrix as ``ndev`` column shards (new tensors; a new tensor at
    1); with ``offset``, shard i is an [R, L] view that starts (offset +
    5 i) % 16 bytes into a buffer of its own, so its rows sit at other
    phases mod 16 than an allocation gives."""
    R, N = heard.shape
    L = N // ndev
    if not offset:
        out = tuple(heard[:, i * L:(i + 1) * L].clone() for i in range(ndev))
    else:
        out = []
        for i in range(ndev):
            o = (offset + 5 * i) % 16
            buf = torch.empty(R * L + 16, dtype=torch.uint8,
                              device=heard.device)
            view = buf[o:o + R * L].view(R, L)
            view.copy_(heard[:, i * L:(i + 1) * L])
            out.append(view)
        out = tuple(out)
    return out if ndev > 1 else out[0]


def _shifted(v: torch.Tensor, offset: int) -> torch.Tensor:
    """``v`` (1-D) as a view ``offset`` bytes into a buffer of its own."""
    buf = torch.empty(v.numel() + 16, dtype=v.dtype, device=v.device)
    out = buf[offset:offset + v.numel()]
    out.copy_(v)
    return out


def _same_rows(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _finish_held(heard, ndev, rx, ok, refute, scratch, offset=0) -> int:
    """One fire launch on a copy (its shards and rx ``offset`` bytes into
    buffers of their own where that is nonzero, ``_split_rows``) against
    the plain version on another; raises unless every byte and ``fired``
    agree.  Returns the bytes the launch changed."""
    from consul_tpu_torch.gossip import finish
    got, ref = _split_rows(heard, ndev, offset), _split_rows(heard, ndev)
    fired = finish.fire_timers(got, _shifted(rx, offset) if offset else rx,
                               ok, refute, scratch)
    want = finish.fire_timers_ref(ref, rx, ok, refute)
    if not (torch.equal(fired, want) and _same_rows(got, ref)):
        raise AssertionError("fire_timers != plain")
    got = torch.cat(got, dim=1) if ndev > 1 else got
    # By row blocks: a count over the whole matrix at once would widen
    # every byte to int64 ([8,192, 1M]: 65 GB).
    return sum(int((a != b).sum()) for a, b in zip(got.split(256),
                                                    heard.split(256)))


def _wipe_held(heard, ndev, flags, offset=0) -> None:
    from consul_tpu_torch.gossip import finish
    got, ref = _split_rows(heard, ndev, offset), _split_rows(heard, ndev)
    finish.wipe_rows(got, flags)
    finish.wipe_rows_ref(ref, flags)
    if not _same_rows(got, ref):
        raise AssertionError("wipe_rows != plain")


def _first_launch_ms(heard, ndev, rx, ok, refute, scratch) -> float:
    """The fire pass's device time on fresh bytes, where they change:
    CUDA-graph replays of the matrix restored from a copy and then the
    launch, less replays of the restore alone."""
    from consul_tpu_torch.gossip import finish
    h, src = _split_rows(heard, ndev), _split_rows(heard, ndev)
    pairs = list(zip(*((h, src) if ndev > 1 else ((h,), (src,)))))

    def restore():
        for a, b in pairs:
            a.copy_(b)

    both = graph_ms(lambda: (restore(),
                             finish.fire_timers(h, rx, ok, refute, scratch)))
    return both - graph_ms(restore)


def finish_phase(card_line: str, seeds: int = 64) -> dict:
    """``fire_timers`` and ``wipe_rows`` (``csrc/finish.cu``) against
    ``fire_timers_ref`` and ``wipe_rows_ref`` on the card, tolerance 0 in
    every byte and in ``fired``, at ``FINISH_SHAPES`` over ``seeds`` fresh
    inputs each: the fire with the timer masks of every row, of a few and
    of none, each with the refutation, and of every row without it; the
    wipe of a few rows (the last among them), of none and of every row;
    every fourth seed with the shards and rx at odd byte offsets.
    Times from CUDA-graph replays (20 launches a graph; a replayed fire
    finds its bytes already DEAD, so it reads its rows and writes none),
    the fire on fresh bytes (``_first_launch_ms``), the plain versions'
    and the wipe's one PyTorch call (``masked_fill_`` on the whole
    matrix), each beside the bytes bound of the rows the launch reads and
    writes (``_finish_bound``)."""
    from consul_tpu_torch.gossip import finish, observe

    t0 = time.perf_counter()
    rows, held, held_offset = {}, 0, 0
    for R, N, ndev in FINISH_SHAPES:
        sc = observe.counts_scratch(R, "cuda")  # a round program's
        for seed in range(seeds):
            heard, rx, ok_all, ok_few, refute, flags = _finish_inputs(
                R, N, 2000 * R + seed)
            none = torch.zeros_like(ok_all)
            off = 1 + seed % 15 if seed % 4 == 3 else 0
            for ok, ref in ((ok_all, refute), (ok_few, refute),
                            (none, refute), (ok_all, None)):
                _finish_held(heard, ndev, rx, ok, ref, sc, off)
                held += 1
                held_offset += off > 0
            for fl in (flags, torch.zeros_like(flags),
                       torch.ones_like(flags)):
                _wipe_held(heard, ndev, fl, off)
                held += 1
                held_offset += off > 0
        heard, rx, ok_all, ok_few, refute, flags = _finish_inputs(R, N, 7)
        none = torch.zeros_like(ok_all)
        changed = _finish_held(heard, ndev, rx, ok_all, refute, sc)
        h = _split_rows(heard, ndev)
        ms = graph_ms(lambda: finish.fire_timers(h, rx, ok_all, refute, sc))
        ms_few = graph_ms(lambda: finish.fire_timers(h, rx, ok_few, refute,
                                                     sc))
        ms_none = graph_ms(lambda: finish.fire_timers(h, rx, none, refute,
                                                      sc))
        ms_first = _first_launch_ms(heard, ndev, rx, ok_all, refute, sc)
        plain_ms = cuda_ms(lambda: finish.fire_timers_ref(h, rx, ok_all,
                                                          refute),
                           iters=5 if N >= 250_000 else 20)
        n_few = int(flags.sum())
        wipe_ms = graph_ms(lambda: finish.wipe_rows(h, flags))
        no_flags = torch.zeros_like(flags)
        wipe_ms_none = graph_ms(lambda: finish.wipe_rows(h, no_flags))
        ones = torch.ones_like(flags)
        wipe_ms_all = graph_ms(lambda: finish.wipe_rows(h, ones))
        wipe_plain_ms = cuda_ms(lambda: finish.wipe_rows_ref(h, flags),
                                iters=5 if N >= 250_000 else 20)
        # The one PyTorch call that computes the wipe: ``masked_fill_`` on
        # the whole [R, N] matrix, whatever the shards.
        wipe_library_ms = cuda_ms(
            lambda: heard.masked_fill_(flags[:, None], 0),
            iters=5 if N >= 250_000 else 20)
        bound = _finish_bound(R, N, R, 0)
        first = _finish_bound(R, N, R, changed)
        few = _finish_bound(R, N, FINISH_FEW, 0)
        wipe = _finish_bound(R, N, 0, n_few * N, rx=False)
        wipe_all = _finish_bound(R, N, 0, R * N, rx=False)
        rows[f"{R}x{N}" + (f"/{ndev}" if ndev > 1 else "")] = {
            "shape": [R, N], "ndev": ndev, "L": N // ndev,
            "ms": ms, **bound, "share_of_bound": bound["bound_ms"] / ms,
            "ms_first": ms_first, "bytes_changed_first": changed,
            "bound_first_ms": first["bound_ms"],
            "share_of_bound_first": (first["bound_ms"] / ms_first
                                     if ms_first > 0 else None),
            "ms_few": ms_few, "few_rows": FINISH_FEW,
            "bound_few_ms": few["bound_ms"], "ms_no_row": ms_none,
            "bound_no_row_ms": _finish_bound(R, N, 0, 0)["bound_ms"],
            "plain_ms": plain_ms,
            "wipe_ms": wipe_ms, "wipe_rows": n_few,
            "wipe_bound_ms": wipe["bound_ms"],
            "wipe_share_of_bound": wipe["bound_ms"] / wipe_ms,
            "wipe_ms_no_row": wipe_ms_none, "wipe_ms_all": wipe_ms_all,
            "wipe_bound_all_ms": wipe_all["bound_ms"],
            "wipe_share_of_bound_all": wipe_all["bound_ms"] / wipe_ms_all,
            "wipe_plain_ms": wipe_plain_ms,
            "wipe_library_ms": wipe_library_ms}
        if int(sc.abs().sum()):
            raise AssertionError(f"fire_timers left its scratch non-zero at "
                                 f"{R}x{N}/{ndev}")
        del heard, rx, ok_all, ok_few, refute, flags, h, none, ones, no_flags
    torch.cuda.empty_cache()
    res = {"phase": "finish", "card": card_line, "tolerance": 0,
           "max_abs_err": 0, "launches_held": held,
           "launches_held_at_offsets": held_offset, "seeds": seeds,
           "operations_per_word": finish_ops_per_word(), "shapes": rows,
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def finish_shapes_vs_plain(shapes: set) -> list:
    """Every (kernel, R, L, ndev, refutation) the paths launched the fire
    pass and the wipe at (``finish.launch_shapes``), on 4 fresh inputs
    against the plain version."""
    from consul_tpu_torch.gossip import observe

    rows = []
    for i, (name, R, L, ndev, has_ref) in enumerate(sorted(shapes)):
        sc = observe.counts_scratch(R, "cuda")
        for seed in range(4):
            heard, rx, ok_all, ok_few, refute, flags = _finish_inputs(
                R, L * ndev, 7000 + 10 * i + seed)
            if name == "fire_timers":
                for ok in (ok_all, ok_few):
                    _finish_held(heard, ndev, rx, ok,
                                 refute if has_ref else None, sc)
            else:
                _wipe_held(heard, ndev, flags)
        rows.append({"kernel": name, "shape": [R, L * ndev], "ndev": ndev,
                     "L": L, "refute": has_ref, "launches_held": 4})
    return rows


# -- the probe tick: the prober lanes, the slot step and the marks ---------------

# (N, S, probe_every, K, loss, nemesis fields or None, LHM threaded, shards,
# free slots) of the probe phase: the 1M round (B = 200,000, K = 3) at the
# main paths' loss 0 and at 0.01, under every nemesis leg (the hash and
# the halves at 0 < p < 1 and at 1, degraded observers with Lifeguard's
# registers); the unaligned 16,001 (padding lanes); 8 shards of the 1M
# round; the WAN pool's two lanes; 600 slots (the merged kernel's slot
# step in three chunks of slots and of candidates); each state with free,
# SUSPECT, DEAD, REFUTED and JOIN slots and more needy targets than free
# slots.
_PROBE_HASH = dict(part_kind="hash", p_ab=0.6, p_ba=0.0)
_PROBE_HALVES = dict(part_kind="contig", p_ab=0.3, p_ba=0.45)
_PROBE_DEGRADED = dict(obs_lo=0, obs_hi=1_000_000, p_obs_miss=0.3,
                       lhm_max=3)
PROBE_CASES = {
    "1m": (1_000_000, 64, 5, 3, 0.0, None, False, 1, 8),
    "1m_loss": (1_000_000, 64, 5, 3, 0.01, None, False, 1, 8),
    "1m_hash": (1_000_000, 64, 5, 3, 0.01, _PROBE_HASH, False, 1, 8),
    "1m_hash_p1": (1_000_000, 64, 5, 3, 0.0, dict(part_kind="hash",
                                                  p_ab=1.0, p_ba=1.0),
                   False, 1, 8),
    "1m_halves": (1_000_000, 64, 5, 3, 0.01, _PROBE_HALVES, False, 1, 8),
    "1m_halves_p1": (1_000_000, 64, 5, 3, 0.0, dict(part_kind="contig",
                                                    p_ab=1.0, p_ba=1.0),
                     False, 1, 8),
    "1m_degraded_lhm": (1_000_000, 64, 5, 3, 0.01, _PROBE_DEGRADED, True,
                        1, 8),
    "16001_all_legs": (16_001, 64, 5, 3, 0.01, dict(
        _PROBE_HASH, obs_lo=0, obs_hi=16_001, p_obs_miss=0.3, lhm_max=3),
        True, 1, 8),
    "16001_k0": (16_001, 64, 5, 0, 0.01, None, False, 1, 8),
    "16001_s600": (16_001, 600, 5, 3, 0.01, None, False, 1, 400),
    "1m_8_shards": (1_000_000, 64, 5, 3, 0.01, None, False, 8, 8),
    "1m_8_shards_legs": (1_000_000, 64, 5, 3, 0.01, dict(
        _PROBE_HALVES, **_PROBE_DEGRADED), True, 8, 8),
    "wan": (12, 32, 10, 3, 0.0, None, False, 1, 4),
}
PROBE_RND = 52


def _probe_params(case):
    """(params, nemesis schedule or None, shards, LHM threaded, free slots)
    of a probe case: a ``PROBE_CASES`` name, or an entry's tuple."""
    from consul_tpu_torch.gossip.nemesis import NemesisParams
    from consul_tpu_torch.gossip.params import SwimParams
    n, S, pe, K, loss, nem_f, lhm, ndev, free = (
        PROBE_CASES[case] if isinstance(case, str) else case)
    p = SwimParams(n=n, slots=S, probe_every=pe, indirect_k=K,
                   loss_rate=loss)
    nem = None
    if nem_f is not None:
        fields = dict(nem_f)
        if "obs_hi" in fields:
            fields["obs_hi"] = min(fields["obs_hi"], n)
        nem = NemesisParams(scenario="probe", start=0, stop=NEVER, **fields)
    return p, nem, ndev, lhm, free


def _probe_inputs(p, nem, ndev: int, lhm: bool, free: int, seed: int):
    """A round's probe-tick inputs on the card, as ``probe.Tick``, with
    its configuration: the round's row under ``prng.key(seed)``; mf with
    non-members, dead and live nodes; half the lanes a live prober of a
    dead member; ``S - free`` live slots in every phase, their subjects
    mostly this round's targets (rearms); every byte value in the matrix;
    ``drops`` near the int32 edge; NemState's registers around the LHM
    ceiling."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel, probe, round_args

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    N, S = p.n, p.slots
    cfg = probe.config(p, kernel.round_variant(p, nem, PROBE_RND), nem)
    B = cfg.B
    ra = round_args.row_args(
        round_args.layout(p.fanout, p.indirect_k),
        torch.from_numpy(round_args.build(p, prng.key(seed), PROBE_RND,
                                          1)[0]).to(dev))
    blk, o_t = int(ra.blk), int(ra.probe[0])
    u = torch.rand(N, device=dev, generator=g)
    mf = torch.where(u < 0.05, -1, torch.where(
        u < 0.1, 10, torch.where(u < 0.12, PROBE_RND, NEVER))).to(
        torch.int32)
    lanes = torch.randperm(B, device=dev, generator=g)
    pids = blk + lanes
    pids = pids[pids < N]
    half = max(1, pids.numel() // 2)
    mf[pids[:half]] = NEVER
    tg = (pids + o_t) % N
    mf[tg[:half]] = torch.where(torch.rand(half, device=dev, generator=g)
                                < 0.5, 10, PROBE_RND).to(torch.int32)
    live = S - free
    # The first forced lane's target keeps no slot: a needy target in
    # every state.
    first = int(tg[0])
    cand = tg[1:max(2, live)].tolist() + rng.permutation(N)[:live].tolist()
    subjects = [x for x in dict.fromkeys(cand) if x != first][:live]
    slot_ids = rng.permutation(S)[:len(subjects)]
    slot_node = np.full(S, -1, np.int32)
    slot_node[slot_ids] = subjects
    slot_phase = np.where(slot_node >= 0, rng.integers(1, 5, S),
                          0).astype(np.int32)
    son = torch.full((N,), -1, dtype=torch.int32, device=dev)
    son[torch.as_tensor(subjects, device=dev).long()] = torch.as_tensor(
        slot_ids, dtype=torch.int32, device=dev)
    heard = torch.randint(0, 256, (S, N), device=dev, dtype=torch.uint8,
                          generator=g)
    if ndev > 1:
        L = N // ndev
        heard = tuple(heard[:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))

    def small(lo, hi, n):
        return torch.from_numpy(rng.integers(lo, hi, n).astype(
            np.int32)).to(dev)

    regs = (torch.from_numpy(slot_node).to(dev),
            torch.from_numpy(slot_phase).to(dev), small(0, 9, S),
            small(0, PROBE_RND, S), small(0, 4, S),
            torch.from_numpy(np.where(rng.random(S) < 0.5, -1,
                                      rng.integers(0, PROBE_RND, S))
                             .astype(np.int32)).to(dev))
    ns = None
    if lhm:
        top = nem.lhm_max
        ns = kernel.NemState(
            torch.randint(0, top + 1, (N,), device=dev, dtype=torch.int32,
                          generator=g),
            torch.randint(0, top + 2, (N,), device=dev, dtype=torch.int32,
                          generator=g))
        ns.streak[pids[:max(1, half // 2)]] = top + 1
    inc = torch.randint(0, 9, (N,), device=dev, dtype=torch.int32,
                        generator=g)
    drops = torch.tensor(2**31 - 2, dtype=torch.int32, device=dev)
    return cfg, probe.Tick(heard, ra, mf, son, ns, regs, inc, drops,
                           probe.scratch(p, dev))


def _probe_main_inputs(p, ndev: int, seed: int = 5,
                       partition: bool = False):
    """A probe tick's inputs as the 1M main path gives them: every node a
    live member but 1,000 per million failed (dead members, on a stride),
    8 live SUSPECT slots on failed nodes, the matrix zero but those rows
    (random bytes), no nemesis.  ``partition``: as ``partition_heal``'s
    window gives them instead (its contig bisection at p = 1, round
    ``PROBE_RND`` inside [40, 160)): every node live, all S slots SUSPECT
    on random nodes (the window's suspicions hold them), so each crossed
    probe of a node without a slot is a needy target and is dropped."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel, probe, round_args
    from consul_tpu_torch.gossip.nemesis import build

    dev = "cuda"
    N, S = p.n, p.slots
    nem = build("partition_heal", N).nem if partition else None
    cfg = probe.config(p, kernel.round_variant(p, nem, PROBE_RND), nem)
    ra = round_args.row_args(
        round_args.layout(p.fanout, p.indirect_k),
        torch.from_numpy(round_args.build(p, prng.key(seed), PROBE_RND,
                                          1)[0]).to(dev))
    mf = torch.full((N,), NEVER, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    if partition:
        live = torch.randperm(N, device=dev, generator=g)[:S]
    else:
        dead = torch.arange(0, N, 1000, device=dev)
        mf[dead] = 10
        live = dead[:8]
    n_live = live.numel()
    regs = [torch.full((S,), v, dtype=torch.int32, device=dev)
            for v in (-1, 0, 0, 0, 0, -1)]
    son = torch.full((N,), -1, dtype=torch.int32, device=dev)
    regs[0][:n_live] = live.to(torch.int32)
    regs[1][:n_live] = 1
    son[live] = torch.arange(n_live, dtype=torch.int32, device=dev)
    heard = torch.zeros((S, N), dtype=torch.uint8, device=dev)
    heard[:n_live] = torch.randint(0, 256, (n_live, N), device=dev,
                                   dtype=torch.uint8, generator=g)
    if ndev > 1:
        L = N // ndev
        heard = tuple(heard[:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))
    return cfg, probe.Tick(heard, ra, mf, son, None, tuple(regs),
                           torch.zeros(N, dtype=torch.int32, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev),
                           probe.scratch(p, dev))


def _probe_timed(cfg, t, per_hash: float) -> dict:
    """The tick's times on ``t`` (CUDA-graph replays of 20 ticks, the
    state carried from tick to tick): the two launches together and each
    kernel alone, the wipe and marks with no rearmed row and with three
    (rows 0-2), the plain versions' steps (eager: the lanes and the slot
    step together, the wipe and the marks); beside ``_probe_bound``."""
    from consul_tpu_torch.gossip import finish, probe
    did = _probe_held(cfg, t)
    bound = _probe_bound(cfg, t, did, per_hash)
    tk = _tick_copy(t)
    ms = graph_ms(lambda: _tick_kernels(cfg, tk))
    lanes_slots_ms = graph_ms(lambda: probe.probe_lanes_slots(cfg, tk))
    none = torch.zeros(cfg.S, dtype=torch.bool, device="cuda")
    three = none.clone()
    three[:3] = True
    rearm_marks_ms = graph_ms(lambda: probe.probe_rearm_marks(cfg, tk, none))
    rearm_marks_3_ms = graph_ms(
        lambda: probe.probe_rearm_marks(cfg, tk, three))
    tp = _tick_copy(t)
    plain_ms = cuda_ms(lambda: _tick_plain(cfg, tp), iters=5, warm=1)

    def lanes_slots_plain():
        probe.probe_lanes_ref(cfg, tp.ra, tp.mf, tp.heard, tp.slot_of_node,
                              tp.nem_state, tp.sp)
        probe.probe_slots_ref(cfg, tp.ra, tp.slots, tp.slot_of_node,
                              tp.incarnation, tp.drops, tp.sp)

    def rearm_marks_plain():
        finish.wipe_rows_ref(tp.heard, none)
        probe.probe_marks_ref(cfg, tp.ra, tp.heard, tp.slot_of_node, tp.sp)

    plain = {"lanes_slots": lanes_slots_plain,
             "rearm_marks": rearm_marks_plain}
    steps = {f"{k}_plain_ms": cuda_ms(fn, iters=5, warm=1)
             for k, fn in plain.items()}
    return {"stats": did["stats"], "needy": did["needy"],
            "rearmed": did["rearmed"],
            "rearmed_marks": did["rearmed_marks"], "ms": ms,
            "lanes_slots_ms": lanes_slots_ms,
            "lanes_slots_blocks": probe.lanes_slots_blocks(cfg.B),
            "rearm_marks_ms": rearm_marks_ms,
            "rearm_marks_3_ms": rearm_marks_3_ms,
            "rearm_marks_blocks": probe.rearm_marks_blocks(
                cfg.B, cfg.S, cfg.N, _ndev_of(t)),
            "plain_ms": plain_ms, **steps,
            **bound, "share_of_bound": bound["bound_ms"] / ms,
            "lanes_slots_share_of_bound":
                bound["lanes_slots_bound_ms"] / lanes_slots_ms,
            "rearm_marks_share_of_bound":
                bound["rearm_marks_bound_ms"] / rearm_marks_ms,
            "rearm_marks_3_share_of_bound":
                bound["rearm_marks_3_bound_ms"] / rearm_marks_3_ms}


def _ndev_of(t) -> int:
    return len(t.heard) if isinstance(t.heard, tuple) else 1


def _tick_copy(t):
    """The tick's tensors copied (the row shared)."""
    from consul_tpu_torch.gossip import probe
    heard = (tuple(h.clone() for h in t.heard)
             if isinstance(t.heard, tuple) else t.heard.clone())
    ns = None if t.nem_state is None else type(t.nem_state)(
        *(x.clone() for x in t.nem_state))
    return probe.Tick(heard, t.ra, t.mf, t.slot_of_node.clone(), ns,
                      tuple(x.clone() for x in t.slots), t.incarnation,
                      t.drops.clone(), t.sp.clone())


def _tick_leaves(t) -> list:
    heard = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    return [*heard, t.slot_of_node, *(t.nem_state or ()), *t.slots, t.drops,
            t.sp]


def _tick_kernels(cfg, t):
    """The round's two launches of the probe kernels."""
    from consul_tpu_torch.gossip import probe
    rearm, stats = probe.probe_lanes_slots(cfg, t)
    probe.probe_rearm_marks(cfg, t, rearm)
    return rearm, stats


def _tick_plain(cfg, t):
    from consul_tpu_torch.gossip import finish, probe
    probe.probe_lanes_ref(cfg, t.ra, t.mf, t.heard, t.slot_of_node,
                          t.nem_state, t.sp)
    rearm, stats = probe.probe_slots_ref(cfg, t.ra, t.slots, t.slot_of_node,
                                         t.incarnation, t.drops, t.sp)
    finish.wipe_rows_ref(t.heard, rearm)
    probe.probe_marks_ref(cfg, t.ra, t.heard, t.slot_of_node, t.sp)
    return rearm, stats


def _probe_held(cfg, t) -> dict:
    """Each of the tick's kernels on a copy of ``t`` against its plain
    versions on another, every output field compared after each launch
    (tolerance 0); raises on a difference.  Returns the kernels' stats
    and what the tick did."""
    from consul_tpu_torch.gossip import finish, probe
    from consul_tpu_torch.gossip.slot_ops import get_points
    got, want = _tick_copy(t), _tick_copy(t)

    def same(what):
        for i, (x, y) in enumerate(zip(_tick_leaves(got),
                                       _tick_leaves(want))):
            if not torch.equal(x, y):
                raise AssertionError(f"probe {what} != plain (field {i})")

    rearm, stats = probe.probe_lanes_slots(cfg, got)
    probe.probe_lanes_ref(cfg, want.ra, want.mf, want.heard,
                          want.slot_of_node, want.nem_state, want.sp)
    rearm_w, stats_w = probe.probe_slots_ref(
        cfg, want.ra, want.slots, want.slot_of_node, want.incarnation,
        want.drops, want.sp)
    same("lanes_slots")
    if not (torch.equal(rearm, rearm_w) and torch.equal(stats, stats_w)):
        raise AssertionError("probe lanes_slots != plain (rearm or stats)")
    # What the marks read and write: an initiator's slot, and its byte
    # where the slot is live (after the wipe), written where the byte is
    # at most SUSPECT; a byte of a rearmed row is not read (it is 0).
    init = probe._views(cfg, got.sp)[2] != 0
    pid = int(t.ra.blk) + torch.arange(cfg.B, device=init.device)
    s2 = got.slot_of_node[(pid + int(t.ra.probe[0])).remainder(cfg.N)]
    row = s2.clamp(0, cfg.S - 1).long()
    cur = get_points(got.heard, row, pid.clamp(max=cfg.N - 1))
    marked = init & (s2 >= 0)
    in_rearmed = marked & rearm[row]
    probe.probe_rearm_marks(cfg, got, rearm)
    finish.wipe_rows_ref(want.heard, rearm_w)
    probe.probe_marks_ref(cfg, want.ra, want.heard, want.slot_of_node,
                          want.sp)
    same("rearm_marks")
    live0 = t.slots[0] >= 0
    served = int((got.slots[0] >= 0).sum() - live0.sum())
    dropped = (int(got.drops) - int(t.drops)) % 2**32
    absorbed = live0 & ~rearm & (got.slots[4] != t.slots[4])
    return {"stats": stats.tolist(), "rearmed": int(rearm.sum()),
            "served": served, "absorbed": int(absorbed.sum()),
            "dropped": dropped, "needy": served + dropped,
            "marks_slot_reads": int(init.sum()),
            "marks_byte_reads": int((marked & ~in_rearmed).sum()),
            "marks_writes": int((marked & ~in_rearmed
                                 & ((cur >> 6) <= 1)).sum()),
            "rearmed_marks": int(in_rearmed.sum())}


def _probe_work(cfg, t, stats: list) -> dict:
    """What the lanes need on ``t``, lane by lane in the kernel's order:
    mf at every valid prober, at the target of each live one, at each
    helper asked (the helpers of a failed direct probe of a live member,
    in order until one rescues); ``slot_of_node`` at the target of each
    lane that would initiate, and the belief byte there where the target
    holds a slot; the threefry hashes, one a draw that decides (its
    probability strictly between 0 and 1, the lane still undecided).
    Raises unless the acks missed and the suspicions counted so equal the
    kernel's ``stats``."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import probe
    from consul_tpu_torch.gossip.slot_ops import get_points
    N, S, B, K = cfg.N, cfg.S, cfg.B, cfg.K
    dev = t.mf.device
    ra = t.ra
    rnd = int(ra.rnd)
    pid = int(ra.blk) + torch.arange(B, device=dev)
    pvalid = pid < N
    ok = pvalid & (t.mf[pid.remainder(N)] > rnd)
    tgt = (pid + int(ra.probe[0])).remainder(N)
    mf_t = t.mf[tgt]
    member, alive = mf_t >= 0, mf_t > rnd
    k_np, k_no, k_nip, k_nio = ra.k_nem
    hashes = 0

    def below(key, shape, p, ask, j=None):
        # Where ``ask``: the draw's outcome, hashed only at 0 < p < 1.
        nonlocal hashes
        if p <= 0.0 or p >= 1.0:
            return ask & (p >= 1.0)
        hashes += int(ask.sum())
        u = prng.below_ref(key, shape, p, dev)
        return ask & (u if j is None else u[:, j])

    lost = ~alive
    if cfg.part:
        grp = probe.group(cfg.part == 1, N, dev)
        g_p, g_t = grp[pid.remainder(N)], grp[tgt]
        lost = lost | below(k_np, (B,), cfg.p_one,
                            ok & ~lost & (g_p != g_t))
    if cfg.degraded:
        deg = (pid >= cfg.obs_lo) & (pid < cfg.obs_hi)
        lost = lost | below(k_no, (B,), cfg.p_obs, ok & ~lost & deg)
    lost = lost | below(ra.k_dl, (B,), cfg.p_dl, ok & ~lost)
    missed = ok & member & lost
    rescued = torch.zeros_like(missed)
    helpers = 0
    for j in range(K):
        asked = missed & alive & ~rescued
        helpers += int(asked.sum())
        h = (pid + int(ra.probe[1 + j])).remainder(N)
        cand = asked & (t.mf[h] > rnd)
        cand = cand & ~below(ra.k_hl, (B, K), cfg.p_il, cand, j)
        if cfg.part:
            g_h = grp[h]
            cross = (g_p != g_h).to(torch.int32) + (g_h != g_t).to(
                torch.int32)
            if cfg.p_one >= 1.0:
                cand = cand & (cross == 0)
            elif cfg.p_one > 0.0:
                p_leg = torch.where(cross == 1, cfg.p_one, cfg.p_two).to(
                    torch.float32)
                ask = cand & (cross > 0)
                hashes += int((ask & (p_leg < 1.0)).sum())
                u = prng.uniform_ref(k_nip, (B, K), dev)[:, j]
                cand = cand & ~(ask & ((p_leg >= 1.0) | (u < p_leg)))
        if cfg.degraded:
            cand = cand & ~below(k_nio, (B, K), cfg.p_obs, cand & deg, j)
        rescued = rescued | cand
    init = missed & ~rescued
    if t.nem_state is not None:
        lhm, streak = (x[pid.remainder(N)] for x in t.nem_state)
        streak_new = torch.where(
            missed, (streak + 1).clamp(max=cfg.lhm_max + 1), 0)
        init = init & (streak_new > lhm)
    s_t = t.slot_of_node[tgt]
    reads_byte = init & (s_t >= 0)
    cur = get_points(t.heard, s_t.clamp(0, S - 1).long(),
                        pid.clamp(max=N - 1))
    final = init & ~(reads_byte & ((cur >> 6) == 2))
    if int(missed.sum()) != stats[1] or int(final.sum()) != stats[3]:
        raise AssertionError(f"probe bound: the lanes' work emulated "
                             f"({int(missed.sum())} missed, "
                             f"{int(final.sum())} suspicions) is not the "
                             f"kernel's ({stats})")
    return {"probers": int(pvalid.sum()), "targets": int(ok.sum()),
            "helpers": helpers, "slot_reads": int(init.sum()),
            "byte_reads": int(reads_byte.sum()),
            "lhm_lanes": int(pvalid.sum()) if t.nem_state is not None
            else 0, "hashes": hashes}


def _probe_bound(cfg, t, did: dict, per_hash: float) -> dict:
    """The least time of one probe tick's launches (ms): its bytes over
    the memory rate and its hashes' operations over the INT32 rate, the
    larger; and of the merged launch's (the lanes' bytes and the slot
    step's, the hashes).  Bytes, each read or write the data needs once,
    4 an int32 element and 1 a belief byte or flag: the lanes' reads of
    ``_probe_work`` (mf, ``slot_of_node`` and the bytes; NemState's two
    registers read and written at every valid prober) and a flag written
    a lane; the slot step's reads of slot_node and slot_phase, of a
    flag a slot and of the kk minima and 5 counts, its writes of the
    rearm flags, the stats, the minima and counts set back and drops, and
    the registers it changes (an absorb's count read and written, a
    rearm's 5 registers and an allocation's 6 and ``slot_of_node``, with
    the incarnation read for each); the wipe and marks' flags, an
    initiator's slot, outside the rearmed rows the byte where the slot is
    live and the byte written where it is at most SUSPECT
    (``_probe_held``), and N bytes written a rearmed row (the rows this
    tick rearmed; for ``rearm_marks_3``, three).  The reads are scattered:
    at a 32-byte sector a read the needy lanes' rows would move more."""
    B, S, kk = cfg.B, cfg.S, cfg.kk
    work = _probe_work(cfg, t, did["stats"])
    lanes = (4 * (work["probers"] + work["targets"] + work["helpers"]
                  + work["slot_reads"]) + work["byte_reads"]
             + 16 * work["lhm_lanes"] + B)
    slots = (2 * 4 * S + S + 4 * (2 * kk + 5 + 8) + S + 16 + 8
             + 8 * did["absorbed"] + 4 * 6 * did["rearmed"]
             + 4 * 8 * did["served"])
    marks = (B + 4 * did["marks_slot_reads"] + did["marks_byte_reads"]
             + did["marks_writes"])
    rearm_marks = marks + cfg.N * did["rearmed"]
    bytes_ = lanes + slots + rearm_marks
    hashes = work["hashes"]
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = hashes * per_hash / INT32_OPS_PER_S * 1e3
    lanes_ms = lanes / HBM_BYTES_PER_S * 1e3
    merged_ms = (lanes + slots) / HBM_BYTES_PER_S * 1e3
    return {"bytes": bytes_, "lanes_bytes": lanes, "slots_bytes": slots,
            "marks_bytes": marks, "lanes_work": work, "bytes_ms": bytes_ms,
            "hashes": hashes, "operations_per_hash": per_hash,
            "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "lanes_bound_ms": max(lanes_ms, ops_ms),
            "lanes_bound_by": "bytes" if lanes_ms >= ops_ms
            else "operations",
            "slots_bound_ms": slots / HBM_BYTES_PER_S * 1e3,
            "lanes_slots_bound_ms": max(merged_ms, ops_ms),
            "lanes_slots_bound_by": "bytes" if merged_ms >= ops_ms
            else "operations",
            "rearm_marks_bytes": rearm_marks,
            "rearm_marks_bound_ms": rearm_marks / HBM_BYTES_PER_S * 1e3,
            "rearm_marks_3_bound_ms":
                (marks + 3 * cfg.N) / HBM_BYTES_PER_S * 1e3}


def probe_phase(card_line: str, seeds: int = 64) -> dict:
    """The probe tick's kernels (``csrc/probe.cu``: ``probe_lanes_slots``,
    ``probe_rearm_marks``) against their plain versions on the card,
    tolerance 0 in every output field after every step, over ``seeds``
    fresh states of each ``PROBE_CASES`` entry; each state must initiate
    and allocate or drop, and the phase must see rearms, marks in rearmed
    rows and drops.  Times
    (``_probe_timed``) on each case's state and on the 1M main paths'
    (``_probe_main_inputs``, 1 and 8 shards), beside the bound
    (``_probe_bound``: the bytes, and the hashes at the SASS count a
    uniform element of ``threefry.cu`` takes, ``sass_count.py
    --threefry``)."""
    from consul_tpu_torch import sass_count
    from consul_tpu_torch.gossip import finish, probe

    t0 = time.perf_counter()
    sass = sass_count.threefry_counts(sass_count.disassemble("threefry"))
    per_hash = sass["uniform"]["busiest_unit_per_element"]
    probe_sass = sass_count.disassemble("probe")
    kernels_sass = {
        k: {f: v for f, v in sass_count.probe_counts(probe_sass, k).items()
            if f != "by_opcode"} for k in sass_count.PROBE_KERNELS}
    emit({"phase": "probe_sass", **kernels_sass})
    rows, held = {}, 0
    seen = {"rearmed": 0, "rearmed_marks": 0, "dropped": 0, "served": 0}
    for case in PROBE_CASES:
        p, nem, ndev, lhm, free = _probe_params(case)
        for seed in range(seeds):
            cfg, t = _probe_inputs(p, nem, ndev, lhm, free,
                                   9000 + 97 * seed + len(case))
            did = _probe_held(cfg, t)
            held += 1
            if did["stats"][3] == 0 or did["served"] + did["dropped"] == 0:
                raise AssertionError(f"probe {case} seed {seed}: the tick "
                                     f"initiated or allocated nothing: "
                                     f"{did}")
            seen["rearmed"] += did["rearmed"] > 0
            seen["rearmed_marks"] += did["rearmed_marks"] > 0
            seen["dropped"] += did["dropped"] > 0
            seen["served"] += did["served"] > 0
        cfg, t = _probe_inputs(p, nem, ndev, lhm, free, 7)
        rows[case] = {"N": p.n, "S": p.slots, "B": cfg.B, "K": cfg.K,
                      "ndev": ndev, "variant": list(cfg.variant(lhm)),
                      "p_dl": cfg.p_dl, **_probe_timed(cfg, t, per_hash)}
        del t
    # The main paths' data: 1M at loss 0, on one device and on 8 shards,
    # and partition_heal's window (its crossed probes needy targets).
    main = {}
    p, _, _, _, _ = _probe_params("1m")
    for key, ndev, partition in (("1m/1", 1, False), ("1m/8", 8, False),
                                 ("1m_partition_heal/1", 1, True)):
        cfg, t = _probe_main_inputs(p, ndev, partition=partition)
        main[key] = {"N": p.n, "S": p.slots, "B": cfg.B, "ndev": ndev,
                     "variant": list(cfg.variant(False)),
                     **_probe_timed(cfg, t, per_hash)}
        del t
    torch.cuda.empty_cache()
    res = {"phase": "probe", "card": card_line, "tolerance": 0,
           "max_abs_err": 0, "ticks_held": held, "seeds": seeds,
           "states_with": seen, "sass": kernels_sass,
           "cases": rows, "main": main,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not all(seen.values()):
        raise AssertionError(f"probe: the states never rearmed, marked a "
                             f"rearmed row, dropped or allocated: {seen}")
    return res


def probe_shapes_vs_plain(shapes: set) -> list:
    """Every (B, S, N, L, ndev, variant) the paths launched the probe
    kernels at (``probe.launch_shapes``), the whole tick on 4 fresh states
    against the plain versions (probabilities: loss 0.01, the legs at
    0.3 and 0.45, degraded observers over every prober)."""
    from consul_tpu_torch.gossip.nemesis import NemesisParams
    from consul_tpu_torch.gossip.params import SwimParams

    rows = []
    ticks = sorted({s[1:] for s in shapes}, key=repr)
    for i, (B, S, N, L, ndev, (part, degraded, K, lhm)) in enumerate(ticks):
        pe = -(-N // B)
        p = SwimParams(n=N, slots=S, probe_every=pe, indirect_k=K,
                       loss_rate=0.01)
        fields = {}
        if part:
            fields.update(part_kind="hash" if part == 1 else "contig",
                          p_ab=0.3, p_ba=0.45)
        if degraded:
            fields.update(obs_lo=0, obs_hi=N, p_obs_miss=0.3)
        if lhm:
            fields["lhm_max"] = 3
        nem = (NemesisParams(scenario="probe", start=0, stop=NEVER,
                             **fields) if fields else None)
        for seed in range(4):
            cfg, t = _probe_inputs(p, nem, ndev, lhm, min(8, S // 2),
                                   12000 + 10 * i + seed)
            if cfg.B != B:
                raise AssertionError(f"probe shape B={B} at N={N}")
            _probe_held(cfg, t)
        rows.append({"kernel": "probe", "shape": [S, N], "B": B,
                     "ndev": ndev, "L": L,
                     "variant": [part, degraded, K, lhm],
                     "launches_held": 4})
    return rows


# -- the finish step's slot logic -----------------------------------------------

# name -> (n, slots, hot rows or None (every slot), shards, hist banks, LHM
# threaded, refutation, kind of state): the 1M main path's (S = 64, every
# slot), its hot tier (8 of 64), 8 shards, the multi-DC LAN pool (250,000,
# hot tier 8) and WAN pool (12 nodes, 32 slots), the hist banks and
# Lifeguard's LHM on and off; then the states in which every row fires,
# every row expires, or the detections share buckets with the counters
# and banks near 2**31.
FINISH_SLOTS_CASES = {
    "1m": (1_000_000, 64, None, 1, False, False, True, "mixed"),
    "1m_hist_lhm": (1_000_000, 64, None, 1, True, True, True, "mixed"),
    "1m_hot8": (1_000_000, 64, 8, 1, True, False, True, "mixed"),
    "1m_8_shards": (1_000_000, 64, None, 8, True, True, True, "mixed"),
    "lan_250k_hot8": (250_000, 64, 8, 1, True, False, True, "mixed"),
    "wan_12": (12, 32, None, 1, False, False, True, "mixed"),
    "16001_all_fire": (16_001, 64, None, 1, True, False, False, "all_fire"),
    "16000_all_expire": (16_000, 64, None, 8, True, True, True,
                         "all_expire"),
    "16001_collide_wrap": (16_001, 64, None, 1, True, True, True,
                           "collide_wrap"),
}
FINISH_SLOTS_LHM_MAX = 3


def _finish_slots_params(spec):
    """(params, the step's configuration, the round) of a case: the WAN
    pool's profile at 12 nodes, else the LAN profile; the round past every
    timer and the TTL."""
    from consul_tpu_torch.gossip import finish_slots
    from consul_tpu_torch.gossip.nemesis import NemesisParams
    from consul_tpu_torch.gossip.params import lan_profile, wan_profile
    n, S, hot, _, _, lhm, refute, _ = spec
    make = wan_profile if n == 12 else lan_profile
    p = make(n, slots=S, hot_slots=hot or 0, refute=refute)
    nem = (NemesisParams(scenario="probe", start=0, stop=NEVER,
                         lhm_max=FINISH_SLOTS_LHM_MAX) if lhm else None)
    rnd = max(1000, p.slot_ttl_rounds + 200)
    return p, finish_slots.config(p, nem), rnd


def _finish_slots_inputs(spec, seed: int):
    """A round's finish-step inputs on the card, as ``finish_slots.Step``,
    with its configuration and ``rx_ok``: the live slots' subjects
    distinct, every phase, half the starts and dead rounds on the edges of
    the timers, the TTL and the GC window; the first live rows forced to
    refute, to fire on a failed subject (a detection) and on a live one
    (a false dead), and to expire DEAD and REFUTED; every byte value in
    the matrix, 30% of it SUSPECT; hot cases list their live slots and
    then free ones (padding rows)."""
    from consul_tpu_torch.gossip import finish_slots
    from consul_tpu_torch.gossip.kernel import HistBank
    n, S, hot, ndev, has_hist, lhm, _, kind = spec
    p, cfg, rnd = _finish_slots_params(spec)
    dev = "cuda"
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    gc, top = cfg.gc_rounds, cfg.tbl[0]
    live = max(1, min(S if hot is None or kind == "all_expire"
                      else hot - 3, n))
    subjects = rng.permutation(n)[:live].astype(np.int32)
    slots = np.sort(rng.permutation(S)[:live])
    slot_node = np.full(S, -1, np.int32)
    slot_node[slots] = subjects
    phase = np.zeros(S, np.int32)
    phase[slots] = rng.choice([1, 1, 2, 3, 4], live)
    edges = [p.slot_ttl_rounds, p.slot_ttl_rounds + 1] + [
        e for v in p.timeout_table() for e in (int(v), int(v) - 1)]
    start = np.zeros(S, np.int32)
    start[slots] = rnd - np.where(rng.random(live) < 0.5,
                                  rng.choice(edges, live),
                                  rng.integers(0, top + 120, live))
    dead = np.full(S, -1, np.int32)
    late = slots[(phase[slots] != 1) | (rng.random(live) < 0.2)]
    dead[late] = rnd - np.where(rng.random(late.size) < 0.5,
                                rng.choice([gc, gc + 1], late.size),
                                rng.integers(0, 3 * gc, late.size))
    nsusp = rng.integers(0, 5, S).astype(np.int32)
    u = torch.rand(n, device=dev, generator=g)
    fail = torch.where(u < 0.6, NEVER, torch.where(
        u < 0.8, rnd - 40, torch.where(u < 0.9, rnd, rnd + 3))).to(
        torch.int32)
    member = torch.rand(n, device=dev, generator=g) < 0.92
    heard = torch.randint(0, 256, (S, n), device=dev, dtype=torch.uint8,
                          generator=g)
    # 30% of the bytes SUSPECT; past 2**31 bytes by row blocks (the
    # uniforms of [8,192, 1M] at once would take 32 GB).
    block = S if S * n <= 1 << 31 else 256
    for r in range(0, S, block):
        h = heard[r:r + block]
        susp = (torch.randint(0, 64, h.shape, device=dev, dtype=torch.uint8,
                              generator=g) | 0x40)
        h.copy_(torch.where(torch.rand(h.shape, device=dev, generator=g)
                            < 0.3, susp, h))
        del susp

    def own(s, msg):
        x = int(slot_node[s])
        heard[s, x] = (msg << 6) | (int(heard[s, x]) & 0x3F)

    subj = torch.from_numpy(subjects).to(dev).long()
    if kind == "mixed" and live >= 5:
        a, b, c, d, e = (int(x) for x in slots[:5])
        for s in (a, b, c):
            phase[s], start[s], dead[s] = 1, rnd - top - 5, -1
        na, nb, nc = (int(slot_node[s]) for s in (a, b, c))
        fail[na], member[na] = NEVER, True
        own(a, 2)
        fail[nb] = rnd - 40
        fail[nc], member[nc] = NEVER, True
        own(c, 0)
        phase[d], dead[d] = 2, rnd - gc - 3
        phase[e], dead[e] = 3, rnd - gc - 1
    elif kind == "all_fire":
        phase[slots], start[slots], dead[slots] = 1, rnd - top - 1, -1
    elif kind == "all_expire":
        phase[slots] = rng.choice([2, 3, 4], live)
        dead[slots] = rnd - gc - 1 - rng.integers(0, 50, live)
        fail[subj] = rnd - 40
    elif kind == "collide_wrap":
        phase[slots], start[slots], dead[slots] = 1, rnd - top - 2, -1
        far = torch.from_numpy(rng.random(live) < 0.5).to(dev)
        fail[subj] = torch.where(far, rnd - 400, rnd - 7).to(torch.int32)
        fail[subj[: live // 4]] = NEVER
        own(int(slots[0]), 1)
        member[subj[0]] = True
        nsusp[:] = 1
    inc = torch.randint(0, 9, (n,), device=dev, dtype=torch.int32,
                        generator=g)
    inc[subj[0]] = NEVER
    edge = kind == "collide_wrap"

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    son = torch.full((n,), -1, dtype=torch.int32, device=dev)
    son[subj] = i32(slots)
    hist = None
    if has_hist:
        hist = HistBank(*(
            (torch.full((b,), 2**31 - 1, dtype=torch.int32, device=dev)
             - torch.randint(0, 3, (b,), device=dev, dtype=torch.int32,
                             generator=g)) if edge else
            torch.randint(0, 5, (b,), device=dev, dtype=torch.int32,
                          generator=g) for b in (256, 256, 256, 32)))
    lhm_t = None
    if lhm:
        lhm_t = torch.randint(0, FINISH_SLOTS_LHM_MAX + 1, (n,), device=dev,
                              dtype=torch.int32, generator=g)
        lhm_t[subj[0]] = FINISH_SLOTS_LHM_MAX
    idx = np.arange(S, dtype=np.int32)
    if hot is not None:
        idx = np.argsort(-(slot_node >= 0).astype(np.int32),
                         kind="stable")[:hot].astype(np.int32)
    idx_t = i32(idx)
    sub = heard if hot is None else heard[idx_t.long()]
    if ndev > 1:
        L = n // ndev
        sub = tuple(sub[:, i * L:(i + 1) * L].clone() for i in range(ndev))
    stats = tuple(torch.tensor(v, dtype=torch.int32, device=dev) for v in (
        (2**31 - 2, 2**31 - 50, 2**31 - 1, 2**31 - 1) if edge
        else (17, 400, 2, 9)))
    alive = fail > rnd
    t = finish_slots.Step(
        sub, torch.tensor(rnd, dtype=torch.int32, device=dev), idx_t,
        (i32(slot_node), i32(phase), i32(start), i32(dead)),
        i32(np.clip(nsusp - 1, 0, p.max_confirmations)), alive, member,
        fail, son, inc, stats, lhm_t, hist)
    return cfg, t, alive & member


def _finish_slots_main_inputs(ndev: int, hist: bool):
    """The finish step's inputs as the 1M churn main path gives them
    (``lan_profile(1_000_000, slots=64, hot_slots=0)``): every node a live
    member but 1,000 per million failed; 8 live slots on failed nodes, 6
    SUSPECT whose timers run on, one SUSPECT whose timer has run out and
    one DEAD past its GC window; the matrix zero but those rows (random
    bytes)."""
    from consul_tpu_torch.gossip import finish_slots
    from consul_tpu_torch.gossip.kernel import init_hist
    spec = (1_000_000, 64, None, ndev, hist, False, True, "main")
    n, S = spec[0], spec[1]
    _, cfg, rnd = _finish_slots_params(spec)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    fail = torch.full((n,), NEVER, dtype=torch.int32, device=dev)
    failed = torch.arange(0, n, 1000, device=dev)
    fail[failed] = 10
    live = failed[:8]
    regs = [torch.full((S,), v, dtype=torch.int32, device=dev)
            for v in (-1, 0, 0, -1)]
    regs[0][:8] = live.to(torch.int32)
    regs[1][:8] = 1
    regs[2][:8] = rnd - 10
    regs[2][6] = rnd - cfg.tbl[0]
    regs[1][7], regs[3][7] = 2, rnd - cfg.gc_rounds - 1
    son = torch.full((n,), -1, dtype=torch.int32, device=dev)
    son[live] = torch.arange(8, dtype=torch.int32, device=dev)
    heard = torch.zeros((S, n), dtype=torch.uint8, device=dev)
    heard[:8] = torch.randint(0, 256, (8, n), device=dev, dtype=torch.uint8,
                              generator=g)
    if ndev > 1:
        L = n // ndev
        heard = tuple(heard[:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))
    member = torch.ones(n, dtype=torch.bool, device=dev)
    t = finish_slots.Step(
        heard, torch.tensor(rnd, dtype=torch.int32, device=dev),
        torch.arange(S, dtype=torch.int32, device=dev), tuple(regs),
        torch.zeros(S, dtype=torch.int32, device=dev), fail > rnd, member,
        fail, son, torch.zeros(n, dtype=torch.int32, device=dev),
        tuple(torch.zeros((), dtype=torch.int32, device=dev)
              for _ in range(4)), None, init_hist(device=dev) if hist
        else None)
    return cfg, t, (fail > rnd) & member


def _fs_copy(t):
    """The step's tensors copied (the read-only ones shared)."""
    heard = (tuple(h.clone() for h in t.heard)
             if isinstance(t.heard, tuple) else t.heard.clone())
    return t._replace(
        heard=heard, slots=tuple(x.clone() for x in t.slots),
        member=t.member.clone(), slot_of_node=t.slot_of_node.clone(),
        incarnation=t.incarnation.clone(),
        stats=tuple(x.clone() for x in t.stats),
        lhm=None if t.lhm is None else t.lhm.clone(),
        hist=None if t.hist is None else type(t.hist)(
            *(x.clone() for x in t.hist)))


def _fs_leaves(t) -> list:
    heard = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    return [*heard, *t.slots, t.member, t.slot_of_node, t.incarnation,
            *t.stats, *([] if t.lhm is None else [t.lhm]),
            *(t.hist or ())]


def _fs_chain(cfg, t, rx, scratch, plain: bool):
    """The finish step as the round runs it on ``t``: the three kernels
    (or, ``plain``, their plain versions) with the fire pass, the spread's
    count (with the banks) and the GC wipe between them."""
    from consul_tpu_torch.gossip import finish, finish_slots as fs, observe
    if plain:
        dec = fs.finish_decide_ref(cfg, t)
        fired = finish.fire_timers_ref(t.heard, rx, dec.ok_mask, dec.refute)
        st = fs.finish_settle_ref(cfg, t, fired)
    else:
        dec = fs.finish_decide(cfg, t)
        fired = finish.fire_timers(t.heard, rx, dec.ok_mask, dec.refute,
                                   scratch)
        st = fs.finish_settle(cfg, t, fired)
    n_hold = None
    if t.hist is not None:
        n_hold = (observe.heard_counts_ref(t.heard, t.member, cfg.budget,
                                           st.verdict, st.spread)
                  if plain else observe.heard_counts(
                      t.heard, t.member, cfg.budget, st.verdict, st.spread,
                      scratch))[observe.HOLD]
    if plain:
        fs.finish_record_ref(cfg, t, dec, st, n_hold)
        finish.wipe_rows_ref(t.heard, st.expired)
    else:
        fs.finish_record(cfg, t, dec, st, n_hold)
        finish.wipe_rows(t.heard, st.expired)
    return dec, fired, st, n_hold


def _finish_slots_held(cfg, t, rx) -> dict:
    """Each of the step's kernels on a copy of ``t`` against its plain
    version on another, every field and output compared after each launch
    (tolerance 0; the fire pass and the spread's count between them, each
    kernel against its plain version too); raises on a difference.
    Returns what the step did and the bytes each kernel needs
    (``_finish_slots_bound``)."""
    from consul_tpu_torch.gossip import finish, finish_slots as fs, observe
    got, want = _fs_copy(t), _fs_copy(t)
    scratch = observe.counts_scratch(cfg.S, "cuda")

    def same(what, extra=(), extra_w=()):
        for i, (x, y) in enumerate(zip(_fs_leaves(got) + list(extra),
                                       _fs_leaves(want) + list(extra_w))):
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x, y)):
                raise AssertionError(f"finish_slots {what} != plain "
                                     f"(field {i})")

    # Decide loads before it waits for the kernel before it (the copies'
    # last), which must write none of its inputs but the rows: they end
    # first.
    torch.cuda.synchronize()
    dec = fs.finish_decide(cfg, got)
    dec_w = fs.finish_decide_ref(cfg, want)
    same("decide", [dec.ok_mask, *(dec.refute or ())],
         [dec_w.ok_mask, *(dec_w.refute or ())])
    fired = finish.fire_timers(got.heard, rx, dec.ok_mask, dec.refute,
                               scratch)
    fired_w = finish.fire_timers_ref(want.heard, rx, dec_w.ok_mask,
                                     dec_w.refute)
    same("fire", [fired], [fired_w])
    st = fs.finish_settle(cfg, got, fired)
    st_w = fs.finish_settle_ref(cfg, want, fired_w)
    same("settle", list(st), list(st_w))
    n_hold = n_hold_w = None
    if got.hist is not None:
        n_hold = observe.heard_counts(got.heard, got.member, cfg.budget,
                                      st.verdict, st.spread,
                                      scratch)[observe.HOLD]
        n_hold_w = observe.heard_counts_ref(want.heard, want.member,
                                            cfg.budget, st_w.verdict,
                                            st_w.spread)[observe.HOLD]
        same("count", [n_hold], [n_hold_w])
    fs.finish_record(cfg, got, dec, st, n_hold)
    fs.finish_record_ref(cfg, want, dec_w, st_w, n_hold_w)
    same("record")
    return _finish_slots_bound(cfg, t, dec, fired, st, n_hold)


def _finish_slots_bound(cfg, t, dec, fired, st, n_hold) -> dict:
    """What the step did on ``t`` (its state before) and the least bytes
    each kernel must move for it, 4 an int32 element, 1 a bool or byte,
    each read or written once: decide reads the round, a row's slot id,
    subject and phase, a refutable row's own byte and its subject's alive
    and member flags, a SUSPECT row's start and confirmation cap, and
    writes the timer mask (and with the refutation the column and byte);
    a refuting row reads and writes the incarnation (and LHM) and writes
    its phase and dead round, and n_refuted is read and written.  Settle
    reads the round, a row's slot id, fired flag, subject, phase and dead
    round, a live row's start, a new verdict's fail round, writes the
    expired flag and marks (and the spread's mask and verdict), a fired
    row's phase and dead round and the counters that change.  Record reads
    the round, a row's slot id, marks and expired flag, an expired or
    dropped row's subject, writes the member flag and an expired row's
    slot_of_node entry and three registers; with the banks, a row's
    refutation byte and spread flag, a spread row's holders, a dwell row's
    start, a detection's fail round, and each touched bucket read and
    written."""
    il = t.idx.long()
    H = il.numel()
    node0, phase0 = t.slots[0][il], t.slots[1][il]
    refuting = (torch.zeros(H, dtype=torch.bool, device=il.device)
                if dec.refute is None else dec.refute[1] != 0)

    def n(x):
        return int(x.sum())

    refutable = ((phase0 == 1) | (phase0 == 2)) & (node0 >= 0)
    suspect_after = (phase0 == 1) & ~refuting
    lhm, hist = t.lhm is not None, t.hist is not None
    decide = (4 + 12 * H + H + ((5 * H + 3 * n(refutable)) if cfg.refute
                                else 0)
              + n(refuting) * (16 + (8 if lhm else 0))
              + 8 * n(suspect_after) + (8 if n(refuting) else 0))
    det = (st.marks & 1) != 0
    new_v = (st.marks & 2) != 0
    dropped = (st.marks & 4) != 0
    settle = (4 + 17 * H + 4 * n(phase0 > 0) + 4 * n(new_v) + 8 * n(fired)
              + 2 * H + (5 * H if hist else 0) + (16 if n(det) else 0)
              + (8 if n(new_v & ~det) else 0))
    record = (4 + 6 * H + 4 * n(st.expired | dropped) + n(dropped)
              + 16 * n(st.expired))
    touched = 0
    if hist:
        rnd = int(t.rnd)
        node_c = node0.clamp(0, cfg.N - 1).long()
        dwell = (rnd - t.slots[2][il]).clamp(0, 255)
        det_b = (rnd - t.fail_round[node_c]).clamp(0, 255)
        blen = ((n_hold[:, None] >> torch.arange(31, device=il.device))
                > 0).sum(dim=1).clamp(max=31)
        touched = sum(x.unique().numel() for x in (
            det_b[det], dwell[new_v | refuting], dwell[refuting],
            blen[st.spread]))
        record += (2 * H + 4 * n(st.spread) + 4 * n(new_v | refuting)
                   + 4 * n(det) + 8 * touched)
    out = {"rows": H, "refuted": n(refuting), "fired": n(fired),
           "detected": n(det), "false_dead": n(new_v & ~det),
           "expired": n(st.expired), "dropped": n(dropped),
           "spread": n(st.spread) if hist else 0, "buckets": touched,
           "decide_bytes": decide, "settle_bytes": settle,
           "record_bytes": record}
    for k in FINISH_SLOTS_KERNELS:
        out[f"{k}_bound_ms"] = out[f"{k}_bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def _finish_slots_timed(cfg, t, rx, step: bool = True) -> dict:
    """The step's times on ``t`` (CUDA-graph replays of 20 launches, the
    state carried from launch to launch): each kernel alone (decide's
    launches, and record's with the banks, programmatic, each overlapping
    the end of the one before),
    and with ``step`` the whole step as the round runs it (with the fire,
    the count and the wipe); the plain versions' (eager); beside
    ``_finish_slots_bound``.  One copy of ``t`` at a time is held beside
    the chain's (at [8,192, 1M] each is 8.2 GB)."""
    from consul_tpu_torch.gossip import finish_slots as fs, observe
    did = _finish_slots_held(cfg, t, rx)
    scratch = observe.counts_scratch(cfg.S, "cuda")
    tk, t0 = _fs_copy(t), _fs_copy(t)
    torch.cuda.synchronize()  # decide loads before it waits
    dec, fired, st, n_hold = _fs_chain(cfg, t0, rx, scratch, False)
    out = {"did": {k: v for k, v in did.items() if "bound" not in k
                   and "bytes" not in k}}
    for k, fn in (("decide", lambda: fs.finish_decide(cfg, tk)),
                  ("settle", lambda: fs.finish_settle(cfg, tk, fired)),
                  ("record", lambda: fs.finish_record(cfg, tk, dec, st,
                                                      n_hold))):
        ms = graph_ms(fn)
        out[f"{k}_ms"] = ms
        out[f"{k}_bytes"] = did[f"{k}_bytes"]
        out[f"{k}_bound_ms"] = did[f"{k}_bound_ms"]
        out[f"{k}_share_of_bound"] = did[f"{k}_bound_ms"] / ms
    del tk
    tp = _fs_copy(t)
    for k, fn in (("decide", lambda: fs.finish_decide_ref(cfg, tp)),
                  ("settle", lambda: fs.finish_settle_ref(cfg, tp, fired)),
                  ("record", lambda: fs.finish_record_ref(cfg, tp, dec, st,
                                                          n_hold))):
        out[f"{k}_plain_ms"] = cuda_ms(fn, iters=5, warm=1)
    del tp
    if not step:
        return out
    tc = _fs_copy(t)
    out["step_ms"] = graph_ms(lambda: _fs_chain(cfg, tc, rx, scratch,
                                                False))
    del tc
    tq = _fs_copy(t)
    out["step_plain_ms"] = cuda_ms(lambda: _fs_chain(cfg, tq, rx, scratch,
                                                     True), iters=5, warm=1)
    return out


def _tail_decide_inputs(ndev: int):
    """The tail's and decide's inputs: the 1M main path's data
    (``_finish_slots_main_inputs``) with 8 more SUSPECT slots (rows 8-15)
    on live members, whose rows are SUSPECT bytes but at the subject's own
    column, zero there: only the tail's merge makes those bytes SUSPECT,
    so those rows refute on the tail's output and on nothing before it.
    Returns ``(cfg, t, tail)``; ``tail()`` runs the round's tail
    (``fused.disseminate``, 3 random shifts) on ``t.heard`` and returns
    its output."""
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile
    cfg, t, rx = _finish_slots_main_inputs(ndev, False)
    n, rnd = cfg.N, int(t.rnd)
    p = lan_profile(n, slots=cfg.S, hot_slots=0)
    rows = list(range(8, 16))
    subjects = [500 + 1000 * k for k in range(8)]  # none failed
    node, phase, start, _ = t.slots
    shards = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    L = shards[0].shape[1]
    for shard in shards:
        shard[8:16] = 0x40  # SUSPECT, conf 0, age 0
    for r, x in zip(rows, subjects):
        node[r], phase[r], start[r] = x, 1, rnd - 10
        t.slot_of_node[x] = r
        shards[x // L][r, x % L] = 0
    rnd_t, offs = fused.tail_args(
        rnd, np.random.default_rng(7).integers(1, n, p.fanout), "cuda")
    sc = None if ndev == 1 else kernel._ShardCtx(ndev, L)

    def tail():
        return fused.disseminate(p, rnd_t, offs, t.heard, t.fail_round, rx,
                                 t.conf_cap, sc, None)

    return cfg, t, tail


def _tail_decide_times(ndev: int) -> dict:
    """The tail alone and the tail then the round's decide on its output
    (``_tail_decide_inputs``; CUDA-graph replays, the state carried)."""
    from consul_tpu_torch.gossip import finish_slots as fs
    cfg, t, tail = _tail_decide_inputs(ndev)
    return {"tail_ms": graph_ms(tail),
            "pair_ms": graph_ms(lambda: fs.decide(
                cfg, t._replace(heard=tail())))}


def _joined_graph_run(capture, warm, check, before=None,
                      looped: bool = False) -> dict:
    """``capture()`` captured by ``torch.cuda.graph`` into a segment
    graph (``warm()`` run first on a side stream), the segment joined
    under an IF node on a true predicate as ``round_graph_build`` joins
    the round's (``round_graph_edges``: the chooser node of a cond, then
    the IF node; the edges of the segment and of the child graph in the IF
    node's body, by type); with ``looped`` that cond inside the IF body
    of a one-round loop's variant, as ``round_graph_loop_build`` places a
    round (a WHILE node, the loop kernel, the variant's IF node: three
    levels of conditional nodes); instantiated and launched
    (``before(out)``, where given, first: it may write the capture's
    output buffers); ``check(out)`` then holds ``capture``'s output and
    raises on a difference.  Returns the edges, whether it instantiated,
    launched and held (looped: and ran its one round), and whether the
    programmatic edge was kept; a refusal is returned with its CUDA
    error."""
    from consul_tpu_torch.gossip import program
    lib = program._lib()
    loop, words = None, None
    if looped:
        # One round of variant code 0: one round left, the step at row 0.
        words = (torch.ones(1, dtype=torch.int32, device="cuda"),
                 torch.zeros(1, dtype=torch.int64, device="cuda"),
                 torch.zeros(1, dtype=torch.int32, device="cuda"),
                 torch.zeros(program.LOOP_WORDS, dtype=torch.int64,
                             device="cuda"))
        loop = program._LoopArgs(*(w.data_ptr() for w in words), 1, 1,
                                 program.LOOP_ROUNDS)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = capture()
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    counts = (ctypes.c_int * 4)()
    joined, exe = ctypes.c_void_p(), ctypes.c_void_p()
    rc = lib.round_graph_edges(graph.raw_cuda_graph(), pred.data_ptr(),
                               None if loop is None
                               else ctypes.addressof(loop), counts,
                               ctypes.byref(joined), ctypes.byref(exe))
    res = {"looped": looped, "segment_programmatic_edges": counts[0],
           "segment_other_edges": counts[1],
           "if_body_programmatic_edges": counts[2],
           "if_body_other_edges": counts[3], "instantiated": rc == 0,
           "cuda_error": None if rc == 0
           else lib.round_graph_error(rc).decode()}
    if rc == 0:
        if before is not None:
            before(out)
            torch.cuda.synchronize()
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.round_graph_launch(exe, stream)
        torch.cuda.synchronize()
        res["launched"] = rc == 0
        if rc != 0:
            res["cuda_error"] = lib.round_graph_error(rc).decode()
        else:
            check(out)
            res["held"] = True
            if looped:
                res["loop_runs"] = words[3].tolist()
                # Its one round of code 0 and its one loop kernel.
                V = program.kernel.VARIANT_CODES
                res["held"] = (int(words[0]) == 0 and int(words[1]) == 0
                               and words[3][0].item() == 1
                               and words[3][V + 2].item() == 1
                               and int(words[3].sum()) == 2)
        lib.round_graph_destroy(joined, exe)
    del graph
    torch.cuda.empty_cache()
    res["kept"] = bool(res["instantiated"] and res.get("launched")
                       and counts[0] > 0 and counts[2] > 0)
    return res


def _all_equal(what: str, got: list, want: list) -> None:
    for i, (x, y) in enumerate(zip(got, want)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what} (field {i})")


def pdl_check(ndev: int, looped: bool = False) -> dict:
    """Whether the round's graph keeps decide's programmatic edge, and
    whether decide waits for the tail: the tail (``fused.disseminate``)
    then the round's decide (a programmatic dependent launch) in the
    joined graph (``_joined_graph_run``); the tail's output, the state and
    decide's outputs held against the tail run eagerly and decide's plain
    version on its output, tolerance 0.  On ``_tail_decide_inputs``, where
    8 rows refute only on the tail's output (a decide that read its own
    byte before the tail ended would miss them); raises unless they
    refute.  Raises if the joined graph ran and disagrees."""
    from consul_tpu_torch.gossip import finish_slots as fs
    cfg, t, tail = _tail_decide_inputs(ndev)
    want = _fs_copy(t)
    out_w = tail()
    torch.cuda.synchronize()
    dec_w = fs.finish_decide_ref(cfg, want._replace(heard=out_w))
    refuted = int(dec_w.refute[1].count_nonzero())
    if refuted < 8:
        raise AssertionError(f"pdl_check {ndev}: {refuted} rows refute on "
                             f"the tail's output, 8 expected")
    got, warm = _fs_copy(t), _fs_copy(t)

    def capture():
        out = tail()
        return out, fs.decide(cfg, got._replace(heard=out))

    def check(res):
        out, dec = res
        outs = (out, out_w) if isinstance(out, tuple) else ((out,), (out_w,))
        _all_equal(f"pdl_check {ndev}: the joined graph's tail and decide "
                   f"!= the eager tail and plain decide",
                   [*outs[0], *_fs_leaves(got), dec.ok_mask, *dec.refute],
                   [*outs[1], *_fs_leaves(want), dec_w.ok_mask,
                    *dec_w.refute])

    return {"ndev": ndev, "refuted": refuted,
            **_joined_graph_run(capture, lambda: fs.decide(
                cfg, warm._replace(heard=tail())), check, looped=looped)}


def _count_record_inputs(ndev: int):
    """The spread's count's and record's inputs as the round gives them:
    the 1M main path's data with the hist banks
    (``_finish_slots_main_inputs``), decide, the fire and settle run on
    it, so that slot 7 (DEAD past its GC window) expires with its verdict
    and drops its subject, whose own column of the row is made DEAD first:
    the count reads that member byte before record clears it.  Returns
    ``(cfg, t, dec, st, scratch, subject)``."""
    from consul_tpu_torch.gossip import finish, finish_slots as fs, observe
    cfg, t, rx = _finish_slots_main_inputs(ndev, True)
    subject = int(t.slots[0][7])
    shards = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    L = shards[0].shape[1]
    shards[subject // L][7, subject % L] = 0x80  # DEAD, conf 0, age 0
    scratch = observe.counts_scratch(cfg.S, "cuda")
    torch.cuda.synchronize()  # decide loads before it waits
    dec = fs.finish_decide(cfg, t)
    fired = finish.fire_timers(t.heard, rx, dec.ok_mask, dec.refute,
                               scratch)
    st = fs.finish_settle(cfg, t, fired)
    torch.cuda.synchronize()
    if not (int(st.marks[7]) & fs.DROPPED and bool(st.spread[7])):
        raise AssertionError(f"count_record {ndev}: slot 7 neither drops "
                             f"its subject nor spreads")
    return cfg, t, dec, st, scratch, subject


def _count_record(cfg, t, dec, st, scratch):
    """The spread's count then record, as the round runs them."""
    from consul_tpu_torch.gossip import finish_slots as fs, observe
    n_hold = observe.count(t.heard, t.member, cfg.budget, st.verdict,
                           st.spread, scratch)[observe.HOLD]
    fs.record(cfg, t, dec, st, n_hold)
    return n_hold


def _count_record_times(ndev: int) -> dict:
    """The spread's count alone, record with the banks alone (back-to-back
    programmatic launches, each overlapping the end of the one before)
    and the pair as the round runs it (``_count_record``), on
    ``_count_record_inputs`` (CUDA-graph replays, the state carried)."""
    from consul_tpu_torch.gossip import finish_slots as fs, observe
    cfg, t, dec, st, scratch, _ = _count_record_inputs(ndev)
    n_hold = observe.heard_counts(t.heard, t.member, cfg.budget, st.verdict,
                                  st.spread, scratch)[observe.HOLD]
    return {"count_ms": graph_ms(lambda: observe.heard_counts(
                t.heard, t.member, cfg.budget, st.verdict, st.spread,
                scratch)),
            "record_ms": graph_ms(lambda: fs.finish_record(cfg, t, dec, st,
                                                           n_hold)),
            "pair_ms": graph_ms(lambda: _count_record(cfg, t, dec, st,
                                                      scratch))}


def pdl_record_check(ndev: int, looped: bool = False) -> dict:
    """Whether the round's graph keeps record's programmatic edge behind
    the spread's count, and whether record waits for the count: the pair
    (``_count_record``) in the joined graph (``_joined_graph_run``); the
    holders and every field held against the plain versions and against
    the kernels run eagerly with the card synchronised between them,
    tolerance 0, on ``_count_record_inputs``, where the dropped subject's
    member byte counts among its row's holders only if the count read it
    before record cleared it.  Raises if the joined graph ran and
    disagrees."""
    from consul_tpu_torch.gossip import finish_slots as fs, observe
    cfg, t, dec, st, scratch, subject = _count_record_inputs(ndev)
    want = _fs_copy(t)
    n_hold_w = observe.heard_counts_ref(want.heard, want.member, cfg.budget,
                                        st.verdict, st.spread)[observe.HOLD]
    fs.finish_record_ref(cfg, want, dec, st, n_hold_w)
    if bool(want.member[subject]):
        raise AssertionError(f"pdl_record_check {ndev}: the subject was "
                             f"not dropped")
    apart = _fs_copy(t)
    n_hold_a = observe.heard_counts(apart.heard, apart.member, cfg.budget,
                                    st.verdict, st.spread,
                                    scratch)[observe.HOLD]
    torch.cuda.synchronize()
    fs.finish_record(cfg, apart, dec, st, n_hold_a)
    torch.cuda.synchronize()
    _all_equal(f"pdl_record_check {ndev}: the count and record apart != "
               f"plain", [*_fs_leaves(apart), n_hold_a],
               [*_fs_leaves(want), n_hold_w])
    got, warm = _fs_copy(t), _fs_copy(t)

    def check(n_hold):
        _all_equal(f"pdl_record_check {ndev}: the joined graph's count and "
                   f"record != plain", [*_fs_leaves(got), n_hold],
                   [*_fs_leaves(want), n_hold_w])

    return {"ndev": ndev, "subject": subject,
            "holders_of_the_dropped_row": int(n_hold_w[7]),
            **_joined_graph_run(
                lambda: _count_record(cfg, got, dec, st, scratch),
                lambda: _count_record(cfg, warm, dec, st, scratch), check,
                looped=looped)}


def _fire_settle_inputs(ndev: int):
    """The fire's and settle's inputs as the round gives them: the 1M main
    path's data (``_finish_slots_main_inputs``) with the timers of slots
    0-6 (SUSPECT on failed nodes) run out, so that those rows die only
    through the fire's ``fired``, and decide run on it.  Returns ``(cfg,
    t, dec, rx, scratch)``."""
    from consul_tpu_torch.gossip import finish_slots as fs, observe
    cfg, t, rx = _finish_slots_main_inputs(ndev, False)
    t.slots[2][:7] = int(t.rnd) - cfg.tbl[0]
    scratch = observe.counts_scratch(cfg.S, "cuda")
    torch.cuda.synchronize()  # decide loads before it waits
    dec = fs.finish_decide(cfg, t)
    torch.cuda.synchronize()
    return cfg, t, dec, rx, scratch


def _fire_settle(cfg, t, dec, rx, scratch):
    """The fire then settle, as the round runs them (``finish.fire``,
    ``finish_slots.settle``): ``(fired, settled)``."""
    from consul_tpu_torch.gossip import finish, finish_slots as fs
    fired = finish.fire(t.heard, rx, dec.ok_mask, dec.refute, scratch)
    return fired, fs.settle(cfg, t, fired)


def _fire_settle_times(ndev: int) -> dict:
    """The fire alone, settle alone (back-to-back programmatic launches)
    and the pair as the round runs it (``_fire_settle``), on
    ``_fire_settle_inputs`` (CUDA-graph replays, the state carried: after
    the first fire its rows are DEAD, and the fire reads them and changes
    nothing)."""
    from consul_tpu_torch.gossip import finish, finish_slots as fs
    cfg, t, dec, rx, scratch = _fire_settle_inputs(ndev)
    fired = finish.fire_timers(t.heard, rx, dec.ok_mask, dec.refute,
                               scratch)
    torch.cuda.synchronize()
    return {"fire_ms": graph_ms(lambda: finish.fire_timers(
                t.heard, rx, dec.ok_mask, dec.refute, scratch)),
            "settle_ms": graph_ms(lambda: fs.finish_settle(cfg, t, fired)),
            "pair_ms": graph_ms(lambda: _fire_settle(cfg, t, dec, rx,
                                                     scratch))}


def pdl_settle_check(ndev: int, looped: bool = False) -> dict:
    """Whether the round's graph keeps settle's programmatic edge behind
    the fire, and whether settle waits for the fire: the pair
    (``_fire_settle``) in the joined graph (``_joined_graph_run``), its
    ``fired`` buffer written with the opposite of each row's verdict just
    before the launch, so that a settle that read ``fired`` before the
    fire ended would give other verdicts; ``fired``, settle's outputs and
    every field held against the plain versions and against the kernels
    run apart with the card synchronised between them, tolerance 0, on
    ``_fire_settle_inputs`` (7 rows that die only through ``fired``).
    Raises if the pair apart or the joined graph, where it ran,
    disagrees."""
    from consul_tpu_torch.gossip import finish, finish_slots as fs
    cfg, t, dec, rx, scratch = _fire_settle_inputs(ndev)
    want = _fs_copy(t)
    fired_w = finish.fire_timers_ref(want.heard, rx, dec.ok_mask,
                                     dec.refute)
    st_w = fs.finish_settle_ref(cfg, want, fired_w)
    new = int(((st_w.marks & fs.NEW_VERDICT) != 0).sum())
    if int(fired_w.sum()) < 7 or new < 7:
        raise AssertionError(f"pdl_settle_check {ndev}: {int(fired_w.sum())}"
                             f" rows fire, {new} new verdicts; 7 expected")
    outs_w = [fired_w, *(x for x in st_w if x is not None)]
    apart = _fs_copy(t)
    fired_a = finish.fire_timers(apart.heard, rx, dec.ok_mask, dec.refute,
                                 scratch)
    torch.cuda.synchronize()
    st_a = fs.finish_settle(cfg, apart, fired_a)
    torch.cuda.synchronize()
    _all_equal(f"pdl_settle_check {ndev}: the fire and settle apart != "
               f"plain", [*_fs_leaves(apart), fired_a,
                          *(x for x in st_a if x is not None)],
               [*_fs_leaves(want), *outs_w])
    got, warm = _fs_copy(t), _fs_copy(t)

    def check(res):
        fired, st = res
        _all_equal(f"pdl_settle_check {ndev}: the joined graph's fire and "
                   f"settle != plain",
                   [*_fs_leaves(got), fired,
                    *(x for x in st if x is not None)],
                   [*_fs_leaves(want), *outs_w])

    return {"ndev": ndev, "fired_rows": int(fired_w.sum()),
            "new_verdicts": new,
            **_joined_graph_run(
                lambda: _fire_settle(cfg, got, dec, rx, scratch),
                lambda: _fire_settle(cfg, warm, dec, rx, scratch), check,
                before=lambda res: res[0].copy_(~fired_w), looped=looped)}


def finish_slots_phase(card_line: str, seeds: int = 32) -> dict:
    """The finish step's slot kernels (``csrc/finish_slots.cu``:
    ``finish_decide``, ``finish_settle``, ``finish_record``, with the fire
    pass, the spread's count and the GC wipe between them as the round
    runs them) against their plain versions on the card, tolerance 0 in
    every field and output after every launch, over ``seeds`` fresh states
    of each ``FINISH_SLOTS_CASES`` entry; the phase must see refutations,
    fires, detections, false dead verdicts, expiries, dropped members and
    spread rows.  Times (``_finish_slots_timed``) on the 1M main path's
    data (``_finish_slots_main_inputs``: 1 and 8 shards, and with the
    hist banks) and on the first state of each case, beside the bytes
    bound (``_finish_slots_bound``)."""
    t0 = time.perf_counter()
    rows, held = {}, 0
    seen = {k: 0 for k in ("refuted", "fired", "detected", "false_dead",
                           "expired", "dropped", "spread")}
    for case, spec in FINISH_SLOTS_CASES.items():
        for seed in range(seeds):
            cfg, t, rx = _finish_slots_inputs(spec, 7000 + 89 * seed
                                              + len(case))
            did = _finish_slots_held(cfg, t, rx)
            held += 1
            for k in seen:
                seen[k] += did[k] > 0
        cfg, t, rx = _finish_slots_inputs(spec, 7)
        n, S, hot, ndev, hist, lhm, refute, kind = spec
        rows[case] = {"N": n, "S": S, "H": hot or S, "ndev": ndev,
                      "hist": hist, "lhm": lhm, "refute": refute,
                      "kind": kind, **_finish_slots_timed(cfg, t, rx)}
        del t
    main = {}
    for key, ndev, hist in (("1m/1", 1, False), ("1m/8", 8, False),
                            ("1m_hist/1", 1, True)):
        cfg, t, rx = _finish_slots_main_inputs(ndev, hist)
        main[key] = {"N": cfg.N, "S": cfg.S, "ndev": ndev, "hist": hist,
                     **_finish_slots_timed(cfg, t, rx)}
        del t
    torch.cuda.empty_cache()
    # The tail then decide, as the round runs them (decide a programmatic
    # dependent launch), and whether the round's joined graph keeps that
    # edge.
    pdl = {f"1m/{ndev}": pdl_check(ndev) for ndev in (1, 8)}
    pair = {f"1m/{ndev}": _tail_decide_times(ndev) for ndev in (1, 8)}
    # And the spread's count then record (record programmatic with the
    # banks), the same way.
    pdl.update({f"count_record/1m/{ndev}": pdl_record_check(ndev)
                for ndev in (1, 8)})
    count_record = {f"1m/{ndev}": _count_record_times(ndev)
                    for ndev in (1, 8)}
    # And the fire then settle (settle programmatic behind the fire).
    pdl.update({f"fire_settle/1m/{ndev}": pdl_settle_check(ndev)
                for ndev in (1, 8)})
    fire_settle = {f"1m/{ndev}": _fire_settle_times(ndev)
                   for ndev in (1, 8)}
    # Each pair again inside the loop's nesting (a WHILE node's variant IF
    # node, then the cond's IF node), as the looped round holds them.
    for ndev in (1, 8):
        pdl[f"loop/1m/{ndev}"] = pdl_check(ndev, looped=True)
        pdl[f"loop/count_record/1m/{ndev}"] = pdl_record_check(
            ndev, looped=True)
        pdl[f"loop/fire_settle/1m/{ndev}"] = pdl_settle_check(
            ndev, looped=True)
    res = {"phase": "finish_slots", "card": card_line, "tolerance": 0,
           "max_abs_err": 0, "steps_held": held, "seeds": seeds,
           "states_with": seen, "cases": rows, "main": main,
           "tail_decide": pair, "count_record": count_record,
           "fire_settle": fire_settle, "pdl": pdl,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not all(seen.values()):
        raise AssertionError(f"finish_slots: the states never did some of "
                             f"{seen}")
    for key, r in pdl.items():
        if r["instantiated"] and not r.get("launched"):
            raise AssertionError(f"finish_slots: the joined graph with "
                                 f"a programmatic edge did not launch "
                                 f"({key}): {r}")
        # Settle's edge, and each edge in the loop's nesting: one in the
        # captured segment, one in the IF node's body, and the graph ran
        # and held.
        if key.startswith(("fire_settle/", "loop/")) and not (
                r["kept"] and r.get("held")
                and r["segment_programmatic_edges"] == 1
                and r["if_body_programmatic_edges"] == 1):
            raise AssertionError(f"finish_slots: a programmatic edge "
                                 f"was not kept ({key}): {r}")
    return res


def finish_slots_shapes_vs_plain(shapes: set) -> list:
    """Every (H, S, N, L, ndev, variant) the paths launched the finish
    step's slot kernels at (``finish_slots.launch_shapes``), the whole
    step on 4 fresh states against the plain versions."""
    rows = []
    steps = sorted({s[1:] for s in shapes}, key=repr)
    for i, (H, S, N, L, ndev, (refute, lhm, hist)) in enumerate(steps):
        spec = (N, S, None if H == S else H, ndev, hist, lhm, refute,
                "mixed")
        for seed in range(4):
            cfg, t, rx = _finish_slots_inputs(spec, 13000 + 10 * i + seed)
            _finish_slots_held(cfg, t, rx)
        rows.append({"kernel": "finish_slots", "shape": [H, N], "S": S,
                     "ndev": ndev, "L": L,
                     "variant": [refute, lhm, hist], "launches_held": 4})
    return rows


def path_shapes_vs_plain(shapes: set, store_shapes: set,
                         draw_shapes: set, flood_shapes: set,
                         observe_shapes: set, finish_shapes: set,
                         probe_shapes: set,
                         finish_slots_shapes: set) -> dict:
    """Every (kernel, S, L, ndev, F, budget) that the paths launched at
    (``fused.launch_shapes``) held against the plain version on fresh
    adversarial bytes, under the offset sets of ``_offset_sets`` with F
    shifts each, every set with no drop operand, a random one and the
    bisection's: byte-identical required.  Then every shape the store's
    paths launched its kernels at (``store_shapes``), as
    ``store_shapes_vs_plain`` holds them, and every shape the draws'
    kernel was launched at (``draw_shapes``), as ``draw_shapes_vs_plain``
    holds them, and every shape the event flood was launched at
    (``flood_shapes``), as ``flood_shapes_vs_plain`` holds them, and every
    shape the observers' counts were launched at (``observe_shapes``), as
    ``observe_shapes_vs_plain`` holds them, and every shape the fire pass
    and the wipe were launched at (``finish_shapes``), as
    ``finish_shapes_vs_plain`` holds them, and every shape the probe
    tick's kernels were launched at (``probe_shapes``), as
    ``probe_shapes_vs_plain`` holds them, and every shape the finish
    step's slot kernels were launched at (``finish_slots_shapes``), as
    ``finish_slots_shapes_vs_plain`` holds them."""
    from types import SimpleNamespace

    from consul_tpu_torch.gossip import fused, kernel

    t0 = time.perf_counter()
    rows, err = [], 0
    for i, (name, S, L, ndev, F, budget) in enumerate(sorted(shapes)):
        N, seed, rnd = L * ndev, 100 + i, 50
        # The plain versions read only the spread budget of the params.
        p = SimpleNamespace(spread_budget_rounds=budget)
        heard, mf, rx_ok, cap = adversarial(S, N, seed, "cuda")
        sc = kernel._ShardCtx(ndev, L)
        shards = tuple(h.contiguous() for h in heard.split(L, dim=1))

        def kern(legs, drop):
            r, offs = fused.tail_args(rnd, legs, "cuda")
            if name == "fused_dissem":
                return fused.fused_dissem(heard, offs, mf, rx_ok, cap, r,
                                          budget, drop)
            return fused.fused_merge(shards, offs, mf, rx_ok, cap, r,
                                     budget, drop)

        def plain(legs, drop):
            r, offs = fused.tail_args(rnd, legs, "cuda")
            if name == "fused_dissem":
                return fused.disseminate_ref(p, r, offs, heard, mf, rx_ok,
                                             cap, drop)
            return fused.merge_shards_ref(p, r, offs, shards, mf, rx_ok,
                                          cap, sc, drop)

        variants = _drop_variants(N, _offset_sets(N, L, seed, F), seed)
        if S * N <= 1 << 31:
            err = max([err] + [_held(name, [S, N, ndev],
                                     lambda: kern(o, d),
                                     lambda: plain(o, d))
                               for o, d in variants])
        else:
            # The wide path's [8,192, 1M]: the first offset set's drop
            # variants, the plain version a block of rows at a time (the
            # tail merges each row on its own), so that no int32 copy of
            # the matrix is made.
            variants = variants[:3]
            for o, d in variants:
                _held_rows(name, [S, N, ndev], kern(o, d), lambda r0, r1: (
                    _plain_rows(name, p, rnd, o, heard, shards, mf, rx_ok,
                                cap, sc, d, r0, r1)))
        del heard, shards
        torch.cuda.empty_cache()
        rows.append({"kernel": name, "shape": [S, N], "ndev": ndev,
                     "L": L, "fanout": F, "budget": budget,
                     "launches_held": len(variants)})
    rows += store_shapes_vs_plain(store_shapes)
    rows += draw_shapes_vs_plain(draw_shapes)
    rows += flood_shapes_vs_plain(flood_shapes)
    rows += observe_shapes_vs_plain(observe_shapes)
    rows += finish_shapes_vs_plain(finish_shapes)
    rows += probe_shapes_vs_plain(probe_shapes)
    rows += finish_slots_shapes_vs_plain(finish_slots_shapes)
    res = {"phase": "path_shapes", "shapes": rows, "tolerance": 0,
           "max_abs_err": err, "seconds": time.perf_counter() - t0}
    emit(res)
    kernels = {r["kernel"] for r in rows}
    if kernels != {"fused_dissem", "fused_merge", "kv_apply",
                   "watch_match", "threefry", "event_flood",
                   "heard_counts", "fire_timers", "wipe_rows",
                   "probe", "finish_slots"}:
        raise AssertionError(f"the paths launched only {sorted(kernels)}")
    return res


def _plain_rows(name: str, p, rnd: int, offs, heard, shards, mf, rx_ok,
                cap, sc, drop, r0: int, r1: int):
    """The tail's plain version on rows [r0, r1) of the matrix (each row
    is merged on its own): ``disseminate_ref`` or ``merge_shards_ref``."""
    from consul_tpu_torch.gossip import fused
    r, o = fused.tail_args(rnd, offs, "cuda")
    if name == "fused_dissem":
        return fused.disseminate_ref(p, r, o, heard[r0:r1], mf, rx_ok,
                                     cap[r0:r1], drop)
    return fused.merge_shards_ref(p, r, o, tuple(h[r0:r1] for h in shards),
                                  mf, rx_ok, cap[r0:r1], sc, drop)


def _held_rows(name: str, shape, out, plain_rows, block: int = 512) -> None:
    """A kernel's output against its plain version a block of rows at a
    time (``plain_rows(r0, r1)``); raises unless byte-identical."""
    outs = out if isinstance(out, tuple) else (out,)
    for r0 in range(0, shape[0], block):
        r1 = min(shape[0], r0 + block)
        want = plain_rows(r0, r1)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a[r0:r1], w) for a, w in zip(outs, want)):
            raise AssertionError(f"{name} != plain at {shape}, rows "
                                 f"[{r0}, {r1})")


def _settle() -> None:
    """The replayed rounds' branch counts into the host counters (one
    device read, outside any round): call before reading a count."""
    from consul_tpu_torch.gossip import program
    program.settle_counts()


def _reset_counts() -> None:
    """Every kernel launch count and round counter to 0."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import (events, finish, finish_slots, fused,
                                         kernel, observe, probe, program,
                                         round_table)
    _settle()
    program.launches = 0
    program.loop_launches = 0
    program.looped_rounds = 0
    round_table.launches = 0
    program.copy_bytes = 0
    program.choose_launches = 0
    program.round_replays = 0
    program.join_replays = 0
    events.launches = 0
    observe.launches = 0
    finish.launches = 0
    finish.fire_launches = 0
    finish.wipe_launches = 0
    probe.launches = 0
    for k in PROBE_KERNELS:
        setattr(probe, f"{k}_launches", 0)
    finish_slots.launches = 0
    for k in FINISH_SLOTS_KERNELS:
        setattr(finish_slots, f"{k}_launches", 0)
    kernel.join_rounds = 0
    prng.launches = 0
    prng.calls = 0
    fused.launches = 0
    fused.merge_launches = 0
    fused.drop_launches = 0
    fused.merge_drop_launches = 0
    kernel.host_syncs = 0
    for k in kernel.tail_rounds:
        kernel.tail_rounds[k] = 0


def _draws(rounds: int | None = None) -> dict:
    """The draws' kernel launches since the last ``_reset_counts`` and
    the device draws the paths asked for (``prng.calls``), per round where
    ``rounds`` is given."""
    from consul_tpu_torch import prng
    _settle()
    out = {"draw_launches": prng.launches, "draw_calls": prng.calls}
    if rounds:
        out["draw_launches_per_round"] = prng.launches / rounds
    return out


def _draw_gate(what: str, draws: dict, expected: int) -> None:
    """Every device draw of a card path was one launch of the draws'
    kernel, and they were exactly as many as the round's structure fixes
    (``expected``: 0 on a path with no nemesis partition, the probe tick
    drawing inside its own kernel)."""
    n, calls = draws["draw_launches"], draws["draw_calls"]
    if n != calls or n != expected:
        raise AssertionError(f"{what}: {n} draw launches for {calls} device "
                             f"draws (expected {expected})")


def _observe_gate(what: str, rounds: int) -> dict:
    """The observers' kernel launches since the last ``_reset_counts``
    (settled), on a path that threads the trace or the flight ring and
    the hist banks: one a round for the final matrix and one more a
    non-quiescent round for the spread; raises unless they are exactly
    that many (``rounds``: the rounds run since the reset)."""
    from consul_tpu_torch.gossip import kernel, observe
    _settle()
    busy = kernel.tail_rounds["hot"] + kernel.tail_rounds["full"]
    want = rounds + busy
    if observe.launches != want or want == 0:
        raise AssertionError(f"{what}: {observe.launches} heard_counts "
                             f"launches, expected {want} ({rounds} rounds, "
                             f"{busy} non-quiescent)")
    return {"observe_launches": observe.launches,
            "observe_launches_per_round": observe.launches / rounds}


PROBE_KERNELS = ("lanes_slots", "rearm_marks")
FINISH_SLOTS_KERNELS = ("decide", "settle", "record")


def _round_counts() -> dict:
    """The finish step's and the probe tick's launches since the last
    ``_reset_counts`` (settled), beside what the rounds run since make
    them: ``fire_timers`` once a non-quiescent round; ``wipe_rows`` once a
    join round (the join tick's stale episodes) and once a non-quiescent
    round (the slot GC; the probe tick's rearm wipe is inside
    ``probe_rearm_marks``); each of ``probe.cu``'s two kernels once a
    round (of every pool); each of ``finish_slots.cu``'s three kernels
    once a non-quiescent round; the round program's chooser node
    (``round_graph.cu``) once a replayed round for its tail and once more
    where it has a join tick, none in an eager round."""
    from consul_tpu_torch.gossip import (finish, finish_slots, kernel, probe,
                                         program)
    _settle()
    t = kernel.tail_rounds
    busy = t["hot"] + t["full"]
    return {"choose_launches": program.choose_launches,
            "choose_launches_expected": program.round_replays
            + program.join_replays,
            "fire_launches": finish.fire_launches,
            "wipe_launches": finish.wipe_launches,
            "fire_launches_expected": busy,
            "wipe_launches_expected": kernel.join_rounds + busy,
            "join_rounds": kernel.join_rounds,
            **{f"probe_{k}_launches": getattr(probe, f"{k}_launches")
               for k in PROBE_KERNELS},
            "probe_launches_expected": busy + t["quiescent"],
            **{f"finish_{k}_launches": getattr(finish_slots,
                                               f"{k}_launches")
               for k in FINISH_SLOTS_KERNELS},
            "finish_slots_launches_expected": busy}


def _round_bad(c: dict) -> bool:
    """Whether ``_round_counts``' launches are not exactly what the rounds
    make them, or none were made where the rounds make some."""
    return (c["choose_launches"] != c["choose_launches_expected"]
            or c["fire_launches"] != c["fire_launches_expected"]
            or c["wipe_launches"] != c["wipe_launches_expected"]
            or (c["wipe_launches"] == 0
                and c["wipe_launches_expected"] != 0)
            or c["probe_launches_expected"] == 0
            or any(c[f"probe_{k}_launches"] != c["probe_launches_expected"]
                   for k in PROBE_KERNELS)
            or any(c[f"finish_{k}_launches"]
                   != c["finish_slots_launches_expected"]
                   for k in FINISH_SLOTS_KERNELS))


def _round_gate(what: str) -> dict:
    """Raises unless the chooser's, the fire pass's, the wipe's, the
    probe kernels' and the finish step's slot kernels' launches are
    exactly what the rounds
    run since the last ``_reset_counts`` make them (``_round_counts``),
    and some were made."""
    c = _round_counts()
    if _round_bad(c):
        raise AssertionError(f"{what}: finish and probe launches {c}")
    return c


def _copy_gate(what: str, p, calls: int) -> int:
    """A graphed single-pool path's belief-matrix copies since the last
    ``_reset_counts`` (``program.copy_bytes``, settled): one a call (its
    load into the program's buffers) and one a full-tail round (the tail's
    out-of-place matrix into them), none in a quiescent or hot round;
    raises unless exactly so."""
    from consul_tpu_torch.gossip import kernel, program
    _settle()
    want = p.slots * p.n * (calls + kernel.tail_rounds["full"])
    if program.copy_bytes != want:
        raise AssertionError(f"{what}: {program.copy_bytes} matrix bytes "
                             f"copied, expected {want} ({calls} calls, "
                             f"{kernel.tail_rounds['full']} full tails)")
    return program.copy_bytes


def _full_path_inputs(n: int, steps: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)
    fail = np.full(n, NEVER, np.int32)
    fail[ids[:48]] = rng.integers(0, steps // 2, 48)
    join = np.full(n, NEVER, np.int32)
    join[ids[48:72]] = rng.integers(1, steps // 2, 24)
    return fail, join, join == NEVER


def _run(p, fail, join, member0, steps, seed, dev, ndev=None):
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel

    st = kernel.init_state(p, device=dev)
    st = st._replace(member=torch.from_numpy(member0).to(dev))
    kw = dict(trace=True, join_round=join,
              flight=kernel.init_flight(device=dev),
              hist=kernel.init_hist(device=dev), device=dev)
    if ndev is None:
        return kernel.run_rounds(st, prng.key(seed), fail, p, steps, **kw)
    return kernel.run_rounds_sharded(st, prng.key(seed), fail, p, steps,
                                     ndev=ndev, **kw)


def _diverged(pairs) -> list:
    from consul_tpu_torch.gossip import kernel
    out = []
    for a, b in pairs:
        if isinstance(a, kernel.SwimState):
            a, b = kernel.unshard_state(a), kernel.unshard_state(b)
        for f in a._fields:
            x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
            if x.dtype != y.dtype or not torch.equal(x, y):
                out.append(f"{type(a).__name__}.{f}")
    return out


FULL_PATH = dict(n=16_000, S=64, steps=300, seed=11)
# Worker processes for the CPU runs: two of the card machine's 8 cores
# stay with this process, which drives the card (its rounds are host-
# bound: a worker beside it on one core halves its pace).
CPU_WORKERS = 6


def _full_path_params(n: int, S: int):
    from consul_tpu_torch.gossip.params import lan_profile
    return lan_profile(n, slots=S, dissem="fused", loss_rate=0.01)


def _full_path_cpu(n: int, S: int, steps: int, seed: int):
    """full_path's run on the CPU, in a worker process, as numpy (two
    threads: it is the longest of the CPU runs)."""
    torch.set_num_threads(2)
    fail, join, member0 = _full_path_inputs(n, steps, seed)
    return _as_numpy(*_run(_full_path_params(n, S), fail, join, member0,
                           steps, seed, "cpu"))


def full_path(cpu, n: int, S: int, steps: int, seed: int):
    """The card run against the CPU run (``cpu``: the future of its
    worker process).  Returns the card run's (carry, trace) for
    sharded_full_path."""
    from consul_tpu_torch.gossip import fused

    p = _full_path_params(n, S)
    fail, join, member0 = _full_path_inputs(n, steps, seed)

    _reset_counts()
    t0 = time.perf_counter()
    (st_g, fl_g, hb_g), tr_g = _run(p, fail, join, member0, steps, seed,
                                    "cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    _settle()
    launches = fused.launches
    draws = _draws(steps)
    observed = _observe_gate("full_path", steps)
    finished = _round_gate("full_path")
    copied = _copy_gate("full_path", p, 1)
    t0 = time.perf_counter()
    diverged = _diverged_np(_as_numpy((st_g, fl_g, hb_g), tr_g),
                            cpu.result())
    emit({"phase": "full_path", "n": n, "slots": S, "steps": steps,
          "kernel_launches": launches, **draws, **observed, **finished,
          "matrix_copy_bytes": copied,
          "cuda_s": t_gpu,
          "cpu_wait_s": time.perf_counter() - t0,
          "n_detected": int(st_g.n_detected),
          "n_refuted": int(st_g.n_refuted),
          "members": int(st_g.member.sum()), "diverged": diverged})
    if diverged:
        raise AssertionError(f"card and CPU runs diverged in {diverged}")
    if launches == 0 or int(st_g.n_detected) == 0:
        raise AssertionError("the full-path run exercised no dissemination")
    _draw_gate("full_path", draws, 0)
    return (st_g, fl_g, hb_g), tr_g


def sharded_full_path(single, n: int, S: int, steps: int, seed: int,
                      ndev: int = 8) -> None:
    """full_path's run through run_rounds_sharded on the card, held
    against full_path's card run (``single``)."""
    from consul_tpu_torch.gossip import fused, kernel

    p = _full_path_params(n, S)
    fail, join, member0 = _full_path_inputs(n, steps, seed)
    _reset_counts()
    t0 = time.perf_counter()
    carry, tr = _run(p, fail, join, member0, steps, seed, "cuda", ndev)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    _settle()
    merges, dissems = fused.merge_launches, fused.launches
    tails = dict(kernel.tail_rounds)
    draws = _draws(steps)
    observed = _observe_gate("sharded_full_path", steps)
    finished = _round_gate("sharded_full_path")
    copied = _copy_gate("sharded_full_path", p, 1)
    (st_1, fl_1, hb_1), tr_1 = single
    diverged = _diverged(list(zip((st_1, fl_1, hb_1), carry)) + [(tr_1, tr)])
    emit({"phase": "sharded_full_path", "n": n, "slots": S, "steps": steps,
          "ndev": ndev, "merge_launches": merges,
          "dissem_launches": dissems, "tail_rounds": tails, **draws,
          **observed, **finished, "matrix_copy_bytes": copied,
          "cuda_s": t_gpu, "n_detected": int(carry[0].n_detected),
          "diverged": diverged})
    if diverged:
        raise AssertionError(f"sharded and single-device card runs "
                             f"diverged in {diverged}")
    if merges != tails["hot"] + tails["full"] or dissems != 0:
        raise AssertionError("merge launches != non-quiescent rounds "
                             "(or fused_dissem ran)")
    if tails["hot"] == 0 or tails["full"] == 0:
        raise AssertionError(f"both tails must run: {tails}")
    _draw_gate("sharded_full_path", draws, 0)


def main_path(n: int, S: int, churn_ppm: int, warm: int, block: int,
              blocks: int, ndev: int | None = None,
              observers: bool = False):
    """bench.py's LAN regime on the port: rounds/s over timed blocks;
    through run_rounds_sharded when ``ndev`` is given; with ``observers``
    the flight ring, hist banks and trace threaded, as the plane threads
    them (the observers' kernel launches gated: one a round and one a
    non-quiescent round; none without).  Returns the result line and the
    final state (with ``observers``, the tuple of state, ring and
    banks)."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import fused, kernel, observe, program
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(n, slots=S, hot_slots=0, dissem="fused")
    n_fail = (n * churn_ppm) // 1_000_000 if churn_ppm else 0
    if churn_ppm and n_fail == 0:
        n_fail = 1
    total = warm + block * blocks
    fail = np.full(n, NEVER, np.int32)
    if n_fail:
        # Stride, not modulo: failures land across every block.
        fail[:n_fail] = (np.arange(n_fail, dtype=np.int64) * total) // n_fail
    fail_t = torch.from_numpy(fail).cuda()
    key = prng.key(42)

    carry = {"flight": kernel.init_flight(device="cuda"),
             "hist": kernel.init_hist(device="cuda")} if observers else {}

    def rounds(state, steps):
        kw = dict(carry, trace=True) if observers else {}
        if ndev is None:
            out = kernel.run_rounds(state, key, fail_t, p, steps, **kw)[0]
        else:
            out = kernel.run_rounds_sharded(state, key, fail_t, p, steps,
                                            ndev=ndev, **kw)[0]
        if observers:
            out, carry["flight"], carry["hist"] = out
        return out

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state = kernel.init_state(p)
    t0 = time.perf_counter()
    state = rounds(state, warm)
    int(state.round)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        state = rounds(state, block)
        int(state.round)
        times.append(time.perf_counter() - t0)
    _settle()
    tails = dict(kernel.tail_rounds)
    name = "observers_main_path" if observers else "main_path"
    res = {"phase": name if ndev is None else f"sharded_{name}",
           "n": n, "slots": S, "churn_ppm": churn_ppm, "ndev": ndev,
           "observers": observers,
           "rounds": total, "warmup_s": warm_s, "block_rounds": block,
           "block_s": times,
           "rounds_per_s_mean": block * blocks / sum(times),
           "rounds_per_s_best_block": block / min(times),
           "kernel_launches": fused.launches,
           "merge_launches": fused.merge_launches, "tail_rounds": tails,
           **_draws(total), "graph_launches": program.launches,
           "observe_launches": observe.launches, **_round_counts(),
           "matrix_copy_bytes": program.copy_bytes,
           "matrix_copy_bytes_per_call": p.slots * p.n,
           "host_syncs_per_round": kernel.host_syncs / total,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "n_detected": int(state.n_detected),
           "n_false_dead": int(state.n_false_dead),
           "drops": int(state.drops)}
    # A call is one table launch and one loop launch a chunk of 512
    # rounds, ceil(n / U) loop kernels a chunk of n.
    res.update(_loop_gate(res["phase"], [warm] + [block] * blocks))
    emit(res)
    busy = tails["hot"] + tails["full"]
    if ndev is None and fused.launches != busy:
        raise AssertionError("kernel launches != non-quiescent rounds")
    if ndev is not None and (fused.merge_launches != busy
                             or fused.launches != 0):
        raise AssertionError("merge launches != non-quiescent rounds "
                             "(or fused_dissem ran)")
    # No draw is launched: the probe tick draws inside its own kernel.
    _draw_gate(res["phase"], res, 0)
    # The fire pass once and the wipe twice a non-quiescent round, the
    # wipe once more a round; the matrix copied into the program once a
    # call and once a full-tail round (a healthy run: never in a round).
    _round_gate(res["phase"])
    _copy_gate(res["phase"], p, 1 + blocks)
    if not observers:
        if observe.launches:
            raise AssertionError(f"{res['phase']}: {observe.launches} "
                                 f"heard_counts launches with no observer")
        return res, state
    _observe_gate(res["phase"], total)
    return res, (state, carry["flight"], carry["hist"])


# -- nemesis ------------------------------------------------------------------

# Rounds per scenario at n = 16,000: each run covers the scenario's fault
# window and rounds on both sides of it (kills at round 30 or 40,
# asym_loss from 20, partition_heal [40, 160), flapping [30, 310): two
# down phases and two rejoins).
# The round program's chooser node (``csrc/round_graph.cu``) alone:
# (S, hot_slots) of the 1M main path, the multi-DC LAN pools (hot tier 8),
# the WAN pool's 32 slots, 1,024 and the reference's own provisioning at
# n = 1M and 5 % loss (crossval.loss_sized_slots: 8,192).
CHOOSE_SHAPES = ((64, 0), (64, 8), (32, 0), (1024, 0), (1024, 8),
                 (8192, 0))
# branch_check: graphed rounds against eager ones through every branch.
BRANCH = dict(n=16_000, S=64, hot=8, steps=160, seed=19)


def _choose_slots(S: int, n: int, seed: int) -> torch.Tensor:
    """slot_node [S] on the card with n live slots at random places."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    node = torch.full((S,), -1, dtype=torch.int32, device="cuda")
    node[torch.randperm(S, device="cuda", generator=g)[:n]] = torch.randint(
        0, 1_000_000, (n,), device="cuda", dtype=torch.int32, generator=g)
    return node


def _main_chooser():
    """The chooser node alone on the 1M main path's choice (S = 64, 8
    live, the hot tier off), counting into a run vector of its own."""
    from consul_tpu_torch.gossip import kernel, program
    c = kernel.Choice(_choose_slots(64, 8, seed=1), 2)
    runs = torch.zeros(program.MAX_BRANCHES, dtype=torch.int64,
                       device="cuda")
    n_a = torch.zeros((), dtype=torch.int32, device="cuda")
    return c, runs, n_a, program.Chooser(c, runs, [0, 1], n_a)


def choose_alone_ms(launches: int = 200) -> dict:
    """The chooser node's own device time on the main path's choice: the
    profiler's ``choose_kernel`` rows over ``launches`` launches of its
    graph.  Run after the round_program phase's profiles: a profiler
    session early in the process left the later ones blind to the kernels
    in conditional bodies (the graphs instantiated meanwhile)."""
    from torch.profiler import ProfilerActivity, profile

    from consul_tpu_torch.profile_round import device_kernels, self_device_us
    *_, one = _main_chooser()
    try:
        for _ in range(10):
            one.launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                one.launch()
            torch.cuda.synchronize()
    finally:
        one.close()
    rows = [e for e in device_kernels(prof) if "choose_kernel" in e.key]
    seen = sum(e.count for e in rows)
    return {"ms": sum(self_device_us(e) for e in rows) / 1e3 / max(seen, 1),
            "kernels_profiled": seen, "launches": launches}


def choose_vs_plain() -> dict:
    """The chooser node alone (``program.Chooser``: the node and its
    group's IF nodes, as the round's graph places them, each body adding
    one to its branch's run) against its plain version
    (``program.choose_ref``) on the card, tolerance 0 in the runs of each
    branch, ``branch_runs`` and n_active: every ``CHOOSE_SHAPES`` entry at
    n_active 0, 8, ``hot``, ``hot + 1`` and S, and a cond's group on a
    true and a false bool.  On the 1M main path's choice (S = 64, 8 live,
    hot tier off) its graph's time (the node and the group's IF nodes,
    CUDA events over 200 launches; its own, ``choose_alone_ms``, comes
    after round_program) beside the plain version's (CUDA-graph replays)
    and the bytes bound (slot_node read, the count and the run
    written)."""
    from consul_tpu_torch.gossip import kernel, program
    held = 0
    for S, hot in CHOOSE_SHAPES:
        k = 3 if hot else 2
        bids = [5, 1, 3][:k]
        for n in sorted({0, 8, hot, hot + 1, S} & set(range(S + 1))):
            c = kernel.Choice(_choose_slots(S, n, seed=S + 7 * n), k, hot)
            runs, runs_w = (torch.zeros(8, dtype=torch.int64, device="cuda")
                            for _ in range(2))
            n_a, n_w = (torch.full((), -1, dtype=torch.int32, device="cuda")
                        for _ in range(2))
            ran = program.choose(c, runs, bids, n_a)
            ran_w = program.choose_ref(c, runs_w, bids, n_w)
            torch.cuda.synchronize()
            if not (torch.equal(ran, ran_w) and torch.equal(runs, runs_w)
                    and torch.equal(n_a, n_w) and int(ran.sum()) == 1):
                raise AssertionError(
                    f"choose (S={S}, hot={hot}, n_active={n}): ran "
                    f"{ran.tolist()} runs {runs.tolist()} n {int(n_a)}; "
                    f"plain {ran_w.tolist()} {runs_w.tolist()} {int(n_w)}")
            held += 1
    for b in (True, False):
        pred = torch.tensor(b, device="cuda")
        runs, runs_w = (torch.zeros(4, dtype=torch.int64, device="cuda")
                        for _ in range(2))
        ran = program.choose(kernel.Choice(pred, 1), runs, [2])
        ran_w = program.choose_ref(kernel.Choice(pred, 1), runs_w, [2])
        if not (torch.equal(ran, ran_w) and torch.equal(runs, runs_w)):
            raise AssertionError(f"choose (a cond on {b}): {ran.tolist()} "
                                 f"{runs.tolist()}")
        held += 1
    c, runs, n_a, one = _main_chooser()
    try:
        for _ in range(10):
            one.launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            one.launch()
        end.record()
        end.synchronize()
        graph = start.elapsed_time(end) / 200
    finally:
        one.close()
    plain = graph_ms(lambda: program.choose_ref(c, runs, [0, 1], n_a))
    bound_bytes = 4 * 64 + 4 + 2 * 8
    return {"held": held, "tolerance": 0, "max_abs_err": 0, "S": 64,
            "n_active": 8, "graph_ms": graph, "plain_ms": plain,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bound_bytes": bound_bytes}


def _branch_inputs(n: int, steps: int, seed: int, join: bool):
    """Failures that take the round through every tail: none live for
    the first rounds (quiescent), one at a time from round 10 (the hot
    tier's at most 8), then 24 at once at round 60 (full); with ``join``
    12 pending joiners as well (join rounds)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)
    fail = np.full(n, NEVER, np.int32)
    fail[ids[:4]] = [10, 14, 18, 22]
    fail[ids[4:28]] = 60
    jr = None
    member0 = np.ones(n, bool)
    if join:
        jr = np.full(n, NEVER, np.int32)
        jr[ids[28:40]] = rng.integers(5, steps // 2, 12)
        member0 = jr == NEVER
    return fail, jr, member0


def branch_check(card_line: str, n: int, S: int, hot: int, steps: int,
                 seed: int) -> dict:
    """The branch choice on the card: the chooser node alone against its
    plain version (``choose_vs_plain``), then the graphed round (the
    chooser node a branch group) against the eager round (``graphed=
    False``, the host reading ``which``) from one state, with the flight
    ring, hist banks and trace threaded, at n = 16,000, S = 64 with the
    hot tier's 8 slots, on 1 and 8 shards, with and without join rounds:
    every field and the trace bit-identical (tolerance 0), every tail
    (quiescent, hot, full) taken and, with joins, the join tick; the
    graphed rounds' ``tail_rounds`` and ``join_rounds``, which the
    choosers count on the card (``branch_runs``), equal to the eager
    route's host counts; the chooser's launches one a replayed round and
    one more with a join tick; and every captured graph of the run
    holding one chooser node per branch group (its only kernel nodes of
    its own) and the groups' IF nodes, read from the runtime's
    description of the graph (``round_graph_dot``: ``choose_kernel`` by
    name, no ``set_condition``)."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel, program
    from consul_tpu_torch.gossip.params import lan_profile

    t0 = time.perf_counter()
    alone = choose_vs_plain()
    p = lan_profile(n, slots=S, hot_slots=hot, dissem="fused")
    rows, bad = {}, []
    for ndev in (1, 8):
        for join in (False, True):
            fail, jr, member0 = _branch_inputs(n, steps, seed, join)
            out = {}
            for graphed in (False, True):
                _reset_counts()
                st = kernel.init_state(p, device="cuda")._replace(
                    member=torch.from_numpy(member0).cuda())
                kw = dict(trace=True, join_round=jr,
                          flight=kernel.init_flight(device="cuda"),
                          hist=kernel.init_hist(device="cuda"),
                          device="cuda", graphed=graphed)
                if ndev == 1:
                    res = kernel.run_rounds(st, prng.key(seed), fail, p,
                                            steps, **kw)
                else:
                    res = kernel.run_rounds_sharded(
                        st, prng.key(seed), fail, p, steps, ndev=ndev, **kw)
                _settle()
                out[graphed] = (res, dict(kernel.tail_rounds),
                                kernel.join_rounds, _round_counts())
            (ec, etr), etails, ejoins, ecounts = out[False]
            (gc, gtr), gtails, gjoins, gcounts = out[True]
            diverged = _diverged(list(zip(ec, gc)) + [(etr, gtr)])
            groups = 1 + join
            dot = ROOT / "build" / "round_graph.dot"
            graphs = [g.described(dot)
                      for q in list(program._programs.values())
                      if isinstance(q, program.RoundProgram) and q.p == p
                      and (q.sc is None) == (ndev == 1)
                      and (q.join is not None) == join
                      for g in q.graphs.values()]
            want = {"kernel": groups, "chooser": groups,
                    "conditional": 3 + join, "set_condition": False}
            key = f"ndev{ndev}/{'join' if join else 'no_join'}"
            rows[key] = {
                "diverged": diverged, "tail_rounds_eager": etails,
                "tail_rounds_graphed": gtails, "join_rounds_eager": ejoins,
                "join_rounds_graphed": gjoins,
                "choose_launches": gcounts["choose_launches"],
                "choose_launches_expected":
                    gcounts["choose_launches_expected"],
                "eager_choose_launches": ecounts["choose_launches"],
                "graphs": len(graphs), "graph_nodes": graphs}
            if diverged:
                bad.append(f"{key}: diverged in {diverged}")
            if gtails != etails or gjoins != ejoins:
                bad.append(f"{key}: graphed tails {gtails} joins {gjoins} "
                           f"!= eager {etails} {ejoins}")
            if min(etails.values()) == 0 or (join and ejoins == 0):
                bad.append(f"{key}: a branch never taken: {etails}, "
                           f"{ejoins} join rounds")
            if gcounts["choose_launches"] != steps * groups \
                    or _round_bad(gcounts) or _round_bad(ecounts) \
                    or ecounts["choose_launches"] != 0:
                bad.append(f"{key}: launches graphed {gcounts}, eager "
                           f"{ecounts}")
            if not graphs or any(g != want for g in graphs):
                bad.append(f"{key}: graph nodes {graphs}, each should hold "
                           f"{want}")
    res = {"phase": "branch_check", "card": card_line, "n": n, "slots": S,
           "hot_slots": hot, "steps": steps, "tolerance": 0,
           "choose": alone, "cases": rows,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if bad or kernel._recorder is not None:
        raise AssertionError(f"branch_check: {bad}")
    return res


NEM_STEPS = {"block_kill": 150, "zone_kill": 150, "partition_heal": 180,
             "asym_loss": 100, "flapping": 320, "degraded_observer": 150}
NEM = dict(n=16_000, S=64, seed=13)


def _nem_run(name: str, n: int, S: int, steps: int, seed: int, dev: str,
             ndev: int | None = None, hot: int | None = None,
             first: int = 0):
    """``steps`` rounds of ``run_rounds`` (or ``run_rounds_sharded``)
    under the catalog scenario ``name`` with the hist banks, NemState
    when it needs one, and the trace: ``(carry, trace)``.  ``hot``: the
    hot tier's slots (None: the LAN profile's); ``first``: the round the
    fresh state starts at."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile

    sc = build(name, n)
    p = lan_profile(n, slots=S) if hot is None else lan_profile(
        n, slots=S, hot_slots=hot)
    kw = dict(trace=True, hist=kernel.init_hist(device=dev), nem=sc.nem,
              device=dev)
    if sc.join_round is not None:
        kw["join_round"] = sc.join_round
    if sc.nem.needs_state:
        kw["nem_state"] = kernel.init_nem_state(n, device=dev)
    st = kernel.init_state(p, device=dev)
    if first:
        st = st._replace(round=torch.full_like(st.round, first))
    args = (st, prng.key(seed), sc.fail_round, p, steps)
    if ndev is None:
        return kernel.run_rounds(*args, **kw)
    return kernel.run_rounds_sharded(*args, ndev=ndev, **kw)


def _nem_run_cpu(name: str, n: int, S: int, steps: int, seed: int,
                 hot: int | None = None, first: int = 0):
    """``_nem_run`` on the CPU, in a worker process: the carry and the
    trace as numpy, field by field."""
    torch.set_num_threads(1)
    return _as_numpy(*_nem_run(name, n, S, steps, seed, "cpu", hot=hot,
                               first=first))


def _as_numpy(carry, tr):
    from consul_tpu_torch.gossip import convert
    return ([(type(t).__name__, convert.state_to_numpy(t)) for t in carry],
            convert.state_to_numpy(tr))


def _diverged_np(a, b) -> list:
    """Fields that differ between two ``_as_numpy`` results."""
    (ca, ta), (cb, tb) = a, b
    out = []
    for (name, x), (_, y) in list(zip(ca, cb)) + [(("RoundTrace", ta),
                                                   ("RoundTrace", tb))]:
        out += [f"{name}.{f}" for f in x
                if x[f].dtype != y[f].dtype or not np.array_equal(x[f], y[f])]
    return out


def nemesis_full_path(cpu, n: int, S: int, seed: int) -> dict:
    """All six catalog scenarios at n = 16,000 on the card, each against
    the port's CPU run (``cpu``: scenario -> the future of its worker
    process) and against the card's run on 8 column shards: every field
    of the state, the hist banks, NemState and the trace bit-identical."""
    from consul_tpu_torch.gossip import fused

    rows, bad = {}, []
    t0 = time.perf_counter()
    for name, steps in NEM_STEPS.items():
        _reset_counts()
        t1 = time.perf_counter()
        card = _nem_run(name, n, S, steps, seed, "cuda")
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t1
        _settle()
        drops = fused.drop_launches
        draws = _draws(steps)
        t1 = time.perf_counter()
        card8 = _nem_run(name, n, S, steps, seed, "cuda", ndev=8)
        torch.cuda.synchronize()
        cuda8_s = time.perf_counter() - t1
        _settle()
        single = _as_numpy(*card)
        rows[name] = {
            "steps": steps, "cuda_s": cuda_s, "cuda_8_shards_s": cuda8_s,
            "drop_launches": drops, **draws,
            "merge_drop_launches": fused.merge_drop_launches,
            "n_detected": int(card[0][0].n_detected),
            "n_false_dead": int(card[0][0].n_false_dead),
            "drops": int(card[0][0].drops),
            # Both runs' rounds: the probe kernels once a round each.
            "round_counts": _round_counts(),
            "diverged_8_shards": _diverged_np(single, _as_numpy(*card8))}
        del card, card8
        t1 = time.perf_counter()
        rows[name]["diverged_cpu"] = _diverged_np(single, cpu[name].result())
        rows[name]["cpu_wait_s"] = time.perf_counter() - t1
    res = {"phase": "nemesis_full_path", "n": n, "slots": S, "seed": seed,
           "seconds": time.perf_counter() - t0, "scenarios": rows}
    emit(res)
    for name, row in rows.items():
        if row["diverged_cpu"] or row["diverged_8_shards"]:
            bad.append(name)
        if row["draw_launches"] != row["draw_calls"]:
            bad.append(f"{name}: {row['draw_launches']} draw launches for "
                       f"{row['draw_calls']} device draws")
        if _round_bad(row["round_counts"]):
            bad.append(f"{name}: finish and probe launches "
                       f"{row['round_counts']}")
        partition = name in ("partition_heal", "asym_loss")
        if partition and not (row["drop_launches"] > 0
                              and row["merge_drop_launches"] > 0):
            bad.append(f"{name}: no launch with a drop operand")
    if bad:
        raise AssertionError(f"nemesis_full_path: {bad}")
    return res


def nemesis_main_path(n: int = 1_000_000, S: int = 64, warm: int = 10,
                      before: int = 30, first: int = 30, inside: int = 60,
                      ndev: int | None = None):
    """``partition_heal`` at 1M nodes: rounds/s in a block of rounds
    before the fault window (rounds [warm, 40)), in the window's first
    ``first`` rounds and in the ``inside`` rounds after those, each block
    ending in a device->host read; launches with a drop operand, host
    syncs per round.  Returns the result line and the final state."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile

    sc = build("partition_heal", n)
    assert warm + before == sc.nem.start
    p = lan_profile(n, slots=S, hot_slots=0, dissem="fused")
    fail_t = torch.from_numpy(sc.fail_round).cuda()
    join_t = torch.from_numpy(sc.join_round).cuda()
    key = prng.key(42)

    def rounds(state, steps):
        kw = dict(join_round=join_t, nem=sc.nem)
        if ndev is None:
            return kernel.run_rounds(state, key, fail_t, p, steps, **kw)[0]
        return kernel.run_rounds_sharded(state, key, fail_t, p, steps,
                                         ndev=ndev, **kw)[0]

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state = rounds(kernel.init_state(p), warm)
    int(state.round)
    times = {}
    blocks = {"before": before, "first": first, "inside": inside}
    for label, steps in blocks.items():
        t0 = time.perf_counter()
        state = rounds(state, steps)
        int(state.round)
        times[label] = time.perf_counter() - t0
    total = warm + before + first + inside
    _settle()
    tails = dict(kernel.tail_rounds)
    res = {"phase": ("nemesis_main_path" if ndev is None
                     else "sharded_nemesis_main_path"),
           "scenario": "partition_heal", "n": n, "slots": S, "ndev": ndev,
           "window": [sc.nem.start, sc.nem.stop], "rounds": total,
           "block_rounds": blocks, "block_s": times,
           "rounds_per_s_before_window": before / times["before"],
           "rounds_per_s_window_first": first / times["first"],
           "rounds_per_s_inside_window": inside / times["inside"],
           "tail_rounds": tails,
           "kernel_launches": fused.launches,
           "merge_launches": fused.merge_launches,
           "drop_launches": fused.drop_launches,
           "merge_drop_launches": fused.merge_drop_launches,
           **_draws(total),
           "host_syncs_per_round": kernel.host_syncs / total,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "n_false_dead": int(state.n_false_dead),
           "n_refuted": int(state.n_refuted), "drops": int(state.drops),
           "slots_live": int((state.slot_node >= 0).sum()),
           **_round_counts()}
    emit(res)
    _round_gate(res["phase"])
    launched = (fused.drop_launches if ndev is None
                else fused.merge_drop_launches)
    # Every round inside the window runs the tail with the drops; the
    # bisection opens far more episodes than there are slots.
    if launched != first + inside or res["drops"] == 0:
        raise AssertionError(f"{res['phase']}: {launched} launches with a "
                             f"drop operand in {first + inside} rounds "
                             f"inside the window, drops {res['drops']}")
    # Inside the window one edge-drop launch for the gossip legs and one
    # for the push/pull legs of a push/pull round (the probe tick's draws
    # are made inside its own kernel).
    window = range(sc.nem.start, min(sc.nem.stop, total))
    pushpull = sum(1 for r in window if p.pushpull_every
                   and r % p.pushpull_every == p.pushpull_every - 1)
    _draw_gate(res["phase"], res, len(window) + pushpull)
    return res, state


# -- the round program: the replayed round against the eager round -----------

# Rounds of each round_program case: warm-up (captures included), then
# timed blocks each ending in a device->host read; the two routes start
# from the same state in the same call.
RP = dict(warm=20, block=40, blocks=2)
RP_PROFILED = 10  # rounds of each route under the profiler (churn, 1 card)


def _rp_inputs(churn_ppm: int, scenario: str | None, total: int):
    """The 1M main path's parameters, ground truth and extras: churn on
    bench.py's stride, or partition_heal's schedule from round 30."""
    from consul_tpu_torch.gossip import kernel
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile

    n = 1_000_000
    p = lan_profile(n, slots=64, hot_slots=0, dissem="fused")
    fail = np.full(n, NEVER, np.int32)
    n_fail = n * churn_ppm // 1_000_000
    if n_fail:
        fail[:n_fail] = (np.arange(n_fail, dtype=np.int64) * total) // n_fail
    kw, start = {}, 0
    if scenario:
        sc = build(scenario, n)
        fail = np.minimum(fail, sc.fail_round)
        kw = {"nem": sc.nem, "join_round": torch.from_numpy(
            sc.join_round).cuda()}
        start = sc.nem.start - 10
    st = kernel.init_state(p)._replace(
        round=torch.tensor(start, dtype=torch.int32, device="cuda"))
    return p, torch.from_numpy(fail).cuda(), kw, st


def _rp_route(p, fail_t, kw, st0, ndev, graphed: bool,
              replays: bool = False, observers: bool = True) -> dict:
    """One route over the case's rounds (graphed: looped, or with
    ``replays`` a replay a round): rounds/s over the timed blocks, host
    reads, graph and table launches per call and per round, captures, the
    final carry and the last block's trace; the flight ring, hist banks
    and trace threaded, or with ``observers`` off none of them."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel, observe, program, round_table

    key = prng.key(42)
    carry = ([st0, kernel.init_flight(), kernel.init_hist()] if observers
             else [st0])
    before = {f: getattr(st0, f).clone() for f in st0._fields}

    def rounds(steps):
        a = dict(graphed=graphed, **kw)
        if observers:
            a.update(trace=True, flight=carry[1], hist=carry[2])
        with (_per_round_replays() if replays
              else contextlib.nullcontext()):
            if ndev:
                out, tr = kernel.run_rounds_sharded(carry[0], key, fail_t, p,
                                                    steps, ndev=ndev, **a)
            else:
                out, tr = kernel.run_rounds(carry[0], key, fail_t, p, steps,
                                            **a)
        carry[:] = out if observers else [out]
        return tr

    _reset_counts()
    captures0, capture_s0 = program.captures, program.capture_s
    pool0 = program.pool_bytes
    builds0, build_s0 = program.loop_builds, program.loop_build_s
    t0 = time.perf_counter()
    rounds(RP["warm"])
    int(carry[0].round)
    warm_s = time.perf_counter() - t0
    syncs0, launches0 = kernel.host_syncs, program.launches
    tables0 = round_table.launches
    times = []
    for _ in range(RP["blocks"]):
        t0 = time.perf_counter()
        tr = rounds(RP["block"])
        int(carry[0].round)
        times.append(time.perf_counter() - t0)
    timed = RP["block"] * RP["blocks"]
    _settle()
    busy = kernel.tail_rounds["hot"] + kernel.tail_rounds["full"]
    calls = 1 + RP["blocks"]
    return {"rounds_per_s": timed / sum(times), "block_s": times,
            "observe_launches": observe.launches,
            "observe_launches_expected": (RP["warm"] + timed + busy
                                          if observers else 0),
            **_round_counts(),
            # The matrix into the program's buffers: once a call and once
            # a full-tail round (graphed); the eager round copies none.
            "matrix_copy_bytes": program.copy_bytes,
            "matrix_copy_bytes_expected": p.slots * p.n * (
                calls + kernel.tail_rounds["full"]) if graphed else 0,
            "input_unchanged": all(torch.equal(v, getattr(st0, f))
                                   for f, v in before.items()),
            "warmup_s": warm_s, "ms_per_round": sum(times) * 1e3 / timed,
            "host_syncs_per_call": (kernel.host_syncs - syncs0)
            / RP["blocks"],
            "host_syncs_per_round": (kernel.host_syncs - syncs0) / timed,
            "graph_launches_per_round": (program.launches - launches0)
            / timed,
            "graph_launches_per_call": (program.launches - launches0)
            / RP["blocks"],
            "table_launches_per_call": (round_table.launches - tables0)
            / RP["blocks"],
            "loop_launches": program.loop_launches,
            "captures": program.captures - captures0,
            "capture_s": program.capture_s - capture_s0,
            "pool_bytes": program.pool_bytes - pool0,
            "loop_builds": program.loop_builds - builds0,
            "loop_build_s": program.loop_build_s - build_s0,
            "tail_rounds": dict(kernel.tail_rounds),
            "carry": tuple(carry), "trace": tr}


def _rp_calls_gate(name: str, route: str, r: dict) -> list:
    """A round_program route's graph and table launches a call: looped,
    ceil(rounds / 512) each and ceil(n / U) loop kernels a chunk of n
    rounds (``program.loop_kernels``); replayed, a graph launch a round
    and the same tables; eager, none.  Returns what is wrong."""
    from consul_tpu_torch.gossip import program
    chunks = -(-RP["block"] // program.TABLE_ROWS)
    want = {"eager": (0, 0, 0),
            "graphed": (chunks, chunks,
                        program.loop_kernels(RP["warm"])
                        + RP["blocks"] * program.loop_kernels(RP["block"])),
            "replays": (RP["block"], chunks, 0)}[route]
    got = (r["graph_launches_per_call"], r["table_launches_per_call"],
           r["loop_launches"])
    return ([] if got == want else
            [f"{name} {route}: graph, table and loop launches {got}, "
             f"expected {want}"])


def _rp_profile(p, fail_t, st0, graphed: bool,
                observers: bool = False) -> dict:
    """Device kernels and busy time a round (their durations summed; and
    the union of their spans, which counts a programmatic launch's wait
    behind the kernel before it once), and the card's idle share by each,
    over RP_PROFILED rounds of the route (after a warm call), with the
    flight ring, hist banks and trace threaded or not (``observers``).
    Also the tail's, the draws', the observers', the finish step's, the
    probe tick's and the chooser's kernels as the profiler saw them run
    (``tail_kernel``, ``draw_kernel``, ``counts_kernel``, ``finish::``,
    ``probe::``, ``choose_kernel``, ``loop_kernel``, ``table_kernel``)
    beside the launches the wrappers counted for the same rounds
    (``fused.launches``, ``prng.launches``, ``observe.launches``,
    ``finish``'s, ``probe.launches``, ``program.choose_launches``,
    ``loop_launches``, ``round_table.launches``, settled); the caller
    holds them equal."""
    from torch.profiler import ProfilerActivity, profile

    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import (finish, finish_slots, fused, kernel,
                                         observe, probe, program,
                                         round_table)
    from consul_tpu_torch.profile_round import (device_kernels,
                                                device_timeline,
                                                fresh_loops, self_device_us)

    key = prng.key(42)
    carry = {"flight": kernel.init_flight(),
             "hist": kernel.init_hist()} if observers else {}

    def run(st):
        out = kernel.run_rounds(st, key, fail_t, p, RP_PROFILED,
                                graphed=graphed, trace=observers,
                                **carry)[0]
        if observers:
            out, carry["flight"], carry["hist"] = out
        int(out.round)
        return out

    st = run(st0)
    if graphed:
        # The loop built again after a profiler session, by a call.
        fresh_loops()
        st = run(st)
    _settle()
    tails0, draws0, obs0 = fused.launches, prng.launches, observe.launches
    fire0, wipe0 = finish.fire_launches, finish.wipe_launches
    probe0 = probe.launches
    slots0 = finish_slots.launches
    choose0 = program.choose_launches
    loop0, table0 = program.loop_launches, round_table.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = run(st)
        wall = time.perf_counter() - t0
    _settle()
    rows = device_kernels(prof)
    busy_us = sum(self_device_us(e) for e in rows)
    span_us = device_timeline(prof)[0]

    def seen(name):
        return sum(e.count for e in rows if name in e.key)

    return {"device_kernels_per_round": sum(e.count for e in rows)
            / RP_PROFILED,
            "device_busy_ms_per_round": busy_us / 1e3 / RP_PROFILED,
            "device_span_ms_per_round": span_us / 1e3 / RP_PROFILED,
            "profiled_ms_per_round": wall * 1e3 / RP_PROFILED,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "device_span_idle_share": 1 - span_us / 1e6 / wall,
            "tail_kernels_profiled": seen("tail_kernel"),
            "tail_launches_counted": fused.launches - tails0,
            "draw_kernels_profiled": seen("draw_kernel"),
            "draw_launches_counted": prng.launches - draws0,
            "observe_kernels_profiled": seen("observe::counts_kernel"),
            "observe_launches_counted": observe.launches - obs0,
            "fire_kernels_profiled": seen("finish::fire_kernel"),
            "fire_launches_counted": finish.fire_launches - fire0,
            "wipe_kernels_profiled": seen("finish::wipe_kernel"),
            "wipe_launches_counted": finish.wipe_launches - wipe0,
            "probe_kernels_profiled": seen("probe::"),
            "probe_launches_counted": probe.launches - probe0,
            "finish_slots_kernels_profiled": seen("finish_slots::"),
            "finish_slots_launches_counted": finish_slots.launches - slots0,
            "choose_kernels_profiled": seen("round_graph::choose_kernel"),
            "choose_launches_counted": program.choose_launches - choose0,
            "set_condition_kernels_profiled": seen("set_condition"),
            "loop_kernels_profiled": seen("round_graph::loop_kernel"),
            "loop_launches_counted": program.loop_launches - loop0,
            "table_kernels_profiled": seen("round_table::table_kernel"),
            "table_launches_counted": round_table.launches - table0,
            "loop_device_ms_per_round": sum(
                self_device_us(e) for e in rows
                if "round_graph::loop_kernel" in e.key) / 1e3 / RP_PROFILED,
            "table_device_ms_per_call": sum(
                self_device_us(e) for e in rows
                if "round_table::table_kernel" in e.key) / 1e3,
            "choose_device_ms_per_round": sum(
                self_device_us(e) for e in rows
                if "round_graph::choose_kernel" in e.key) / 1e3
            / RP_PROFILED,
            "finish_slots_device_ms_per_round": sum(
                self_device_us(e) for e in rows
                if "finish_slots::" in e.key) / 1e3 / RP_PROFILED,
            "probe_device_ms_per_round": sum(
                self_device_us(e) for e in rows
                if "probe::" in e.key) / 1e3 / RP_PROFILED,
            "finish_device_ms_per_round": sum(
                self_device_us(e) for e in rows
                if "finish::" in e.key) / 1e3 / RP_PROFILED,
            "observe_device_ms_per_round": sum(
                self_device_us(e) for e in rows
                if "observe::counts_kernel" in e.key) / 1e3 / RP_PROFILED}


def _rp_profile_looped(observers_too: bool = True) -> list:
    """``_rp_profile`` of the graphed churn route, without and with the
    observers, in this process: run in a fresh worker process by
    round_program.  On the H100 the profiler's view of the kernels in a
    loop graph's conditional bodies depends on the profiler sessions the
    process has seen: a loop instantiated before any session shows each
    node once a launch, and one instantiated after several sessions of
    this script (``loop_profiled``, the eager profile) showed none.  A
    fresh process builds its program, then ``_rp_profile`` builds the loop
    again after one profiler session (``profile_round.fresh_loops``),
    which shows every round."""
    total = RP["warm"] + RP["block"] * RP["blocks"]
    p, fail_t, _, st0 = _rp_inputs(1000, None, total)
    return [_rp_profile(p, fail_t, st0, True, observers=obs)
            for obs in ((False, True) if observers_too else (False,))]


def _roll_sharded_views(sc, xs, o: int) -> tuple:
    """What ``_roll_sharded`` did with a host shift before the round's
    shifts moved to the device: with ``q, r = divmod(o mod N, L)``, output
    shard ``i`` joins the last ``r`` columns of shard ``i - q - 1`` and
    the first ``L - r`` of shard ``i - q``."""
    L, nd = sc.L, sc.ndev
    q, r = divmod(o % (L * nd), L)
    return tuple(torch.cat([xs[(i - q - 1) % nd][..., L - r:],
                            xs[(i - q) % nd][..., :L - r]], dim=-1)
                 if r else xs[(i - q) % nd] for i in range(nd))


def _sloc_roll_view(sc, v: torch.Tensor, o: int, i: int) -> torch.Tensor:
    """What ``_sloc_roll`` did with a host shift: shard ``i``'s slice of
    ``torch.roll(v, o)`` as a view, or two slices joined where it wraps."""
    n, start = v.shape[0], (i * sc.L - o) % v.shape[0]
    if start + sc.L <= n:
        return v[start:start + sc.L]
    return torch.cat([v[start:], v[:start + sc.L - n]])


def _gathers_vs_views() -> dict:
    """What the device shifts cost: each gather the round now makes
    against the view or roll it replaces, at 1M, S = 64, B = 200,000, the
    shift a device scalar (ms, CUDA-graph replays, equal results)."""
    from consul_tpu_torch.gossip import kernel

    n, S, B, o = 1_000_000, 64, 200_000, 377_771
    g = torch.Generator(device="cuda").manual_seed(5)
    mf = torch.randint(-1, 2**31 - 1, (n,), device="cuda", dtype=torch.int32,
                       generator=g)
    heard = torch.randint(0, 256, (S, n), device="cuda", dtype=torch.uint8,
                          generator=g)
    o_t = torch.tensor(o, dtype=torch.int32, device="cuda")
    blk = 3 * B
    pid = blk + torch.arange(B, dtype=torch.int32, device="cuda")
    sc = kernel._ShardCtx(8, n // 8)
    shards = tuple(h.contiguous() for h in heard.split(n // 8, dim=1))
    pairs = {
        # the probe tick's window of mf at the prober block plus a shift
        "probe_window": (lambda: mf[(pid + o_t).remainder(n).long()],
                         lambda: torch.cat([mf, mf])[(blk + o) % n:
                                                     (blk + o) % n + B]),
        # push/pull's roll of the belief matrix and of mf
        "pushpull_roll_heard": (lambda: kernel._roll(heard, o_t, 1),
                                lambda: torch.roll(heard, o, dims=1)),
        "pushpull_roll_mf": (lambda: kernel._roll(mf, o_t, 0),
                             lambda: torch.roll(mf, o)),
        # the sharded round's roll (8 shards) and a shard's mf window
        "roll_sharded": (lambda: kernel._roll_sharded(sc, shards, o_t),
                         lambda: _roll_sharded_views(sc, shards, o)),
        "sloc_roll": (lambda: kernel._sloc_roll(sc, mf, o_t, 3),
                      lambda: _sloc_roll_view(sc, mf, o, 3)),
    }
    out = {}
    for name, (gather, view) in pairs.items():
        a, b = gather(), view()
        if isinstance(a, tuple):
            a, b = torch.cat(a, dim=-1), torch.cat(b, dim=-1)
        if not torch.equal(a, b):
            raise AssertionError(f"gathers_vs_views: {name} differs")
        out[name] = {"gather_ms": graph_ms(gather),
                     "replaced_ms": graph_ms(view)}
    return out


# -- the loop: a chunk of rounds as one graph launch --------------------------

# The table kernel's draws of (key, first round, rows) and their
# parameters: the 1M main path's, the multi-DC LAN pool's, the WAN pool's
# (12 servers) and the 16,000 paths'.
TABLE_DRAWS = 320
# A hash's integer instructions on the busiest execution unit (the bits
# loop's SASS count, ``sass_count.py --threefry``): the table's
# operations bound.
HASH_OPS = 51
# The loop at 16,000 nodes: 600 rounds a call (a chunk of 512, one of 88).
LOOP_PATH = dict(n=16_000, S=64, steps=600, seed=31)


def _table_params() -> dict:
    from consul_tpu_torch.gossip.params import lan_profile, wan_profile
    return {"lan_1m": lan_profile(1_000_000, slots=64, hot_slots=0),
            "lan_250k": lan_profile(250_000, slots=64),
            "wan_12": wan_profile(12, slots=32),
            "lan_16k": lan_profile(16_000, slots=64)}


def _table_hashes(p, events: bool) -> int:
    """threefry hashes a row (``csrc/round_table.cu``'s count)."""
    return 2 * p.fanout + 9 if events else (3 * p.fanout
                                            + 2 * p.indirect_k + 26)


def _table_job(p, key, rnd0: int, rows: int, events: bool, nem=None,
               cursor: int = 0, ring: int = 1):
    """A fresh ``round_table.Job`` on the card (its buffers poisoned with
    -7), with the variant column and counters of a round table."""
    from consul_tpu_torch.gossip import round_args, round_table
    width = (round_args.event_layout(p.fanout).width if events
             else round_args.layout(p.fanout, p.indirect_k).width)
    full = torch.full
    job = round_table.Job(p, key, rnd0, full((rows, width), -7,
                                             dtype=torch.int32,
                                             device="cuda"), events=events)
    if events:
        return job
    return job._replace(variant=full((rows,), -7, dtype=torch.int32,
                                     device="cuda"),
                        nem=nem, left=full((1,), -7, dtype=torch.int32,
                                           device="cuda"),
                        step=full((1,), -7, dtype=torch.int64, device="cuda"),
                        cursor=cursor, ring=ring)


def _table_held(j, rows: int) -> int:
    """Words of a filled job that differ from the plain version (its
    table, variant column, counters); 0 when it holds."""
    from consul_tpu_torch.gossip import kernel, round_args
    if j.events:
        want = round_args.build_events(j.p, j.key, j.rnd0, rows)
    else:
        want = round_args.build(j.p, j.key, j.rnd0, rows, j.cursor, j.ring)
    bad = int((j.table.cpu() != torch.from_numpy(want)).sum())
    if j.variant is not None:
        codes = kernel.variant_codes(j.p, j.nem, j.rnd0, rows)
        bad += int((j.variant.cpu() != torch.from_numpy(codes)).sum())
        bad += int(j.left) != rows
        bad += int(j.step) != 0
    return bad


def table_vs_plain(draws: int = TABLE_DRAWS) -> dict:
    """``round_table.fill`` on the card (``table_kernel``) against its plain
    version word for word (``round_args.build`` with a flight ring,
    ``build_events``, and the variant column against
    ``kernel.variant_codes``, which the host holds to ``round_variant``)
    over ``draws`` draws of (parameters, key, first round, rows): rows 1 to
    512, first rounds 0 to 2**31 - rows, every nemesis catalog schedule in
    turn; then the multi-DC call's launch (4 LAN round and event tables
    and the WAN pool's two, one launch) against ``build_pools``.  The
    kernel's time at 512, 30 and 1 rows (CUDA-graph replays, with a
    parent checkout in turns with its kernel, ``_turns``; and back to
    back through the wrapper) beside the plain version's (the host build
    and its copy to the card) and the bound: the hashes' integer
    instructions over the INT32 rate, or the rows' bytes over the memory
    rate."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import nemesis, round_args, round_table
    params = _table_params()
    names = sorted(params)
    scen = sorted(nemesis.CATALOG)
    nems = {}
    rng = np.random.default_rng(22)
    t0 = time.perf_counter()
    bad, held, launches0 = [], 0, round_table.launches
    for i in range(draws):
        name = names[i % len(names)]
        p = params[name]
        key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        rows = int(rng.choice([1, 2, 30, 511, 512]) if i % 3
                   else rng.integers(1, 513))
        rnd0 = int(rng.choice([0, 149, 2**31 - 512]) if i % 4 == 0
                   else rng.integers(0, 2**31 - rows))
        events = i % 5 == 4
        nem = None
        if not events and i % 2:
            sc = scen[(i // 2) % len(scen)]
            if (sc, p.n) not in nems:
                nems[sc, p.n] = nemesis.build(sc, p.n).nem
            nem = nems[sc, p.n]
            rnd0 = int(rng.integers(0, 400)) if i % 4 != 0 else rnd0
        j = _table_job(p, key, rnd0, rows, events, nem,
                       int(rng.integers(0, 2**20)), int(rng.choice([1, 256])))
        round_table.fill([j], rows)
        n_bad = _table_held(j, rows)
        held += 1
        if n_bad:
            bad.append({"draw": i, "params": name, "rows": rows,
                        "rnd0": rnd0, "events": events, "words": n_bad})
    # The multi-DC call's tables: D LAN round and event tables, the WAN
    # pool's two, one launch, against build_pools' vectorised pass.
    D, lan, wan = 4, params["lan_250k"], params["wan_12"]
    keys = np.stack([rng.integers(0, 2**32, 2, dtype=np.uint64).astype(
        np.uint32) for _ in range(D + 1)])
    rounds = [int(r) for r in rng.integers(0, 10_000, 2 * D + 2)]
    rows = 30
    jobs = ([_table_job(lan, keys[d], rounds[d], rows, False)
             ._replace(variant=None, left=None) for d in range(D)]
            + [_table_job(lan, keys[d], rounds[D + d], rows, True)
               for d in range(D)]
            + [_table_job(wan, keys[D], rounds[2 * D], rows, False)
               ._replace(variant=None, left=None),
               _table_job(wan, keys[D], rounds[2 * D + 1], rows, True)])
    before = round_table.launches
    round_table.fill(jobs, rows)
    pools_launches = round_table.launches - before
    want = (round_args.build_pools(lan, keys[:D], rounds[:D], rows),
            round_args.build_pools(lan, keys[:D], rounds[D:2 * D], rows,
                                   events=True))
    for d in range(D):
        for j, w in ((jobs[d], want[0][d]), (jobs[D + d], want[1][d])):
            if not np.array_equal(j.table.cpu().numpy(), w):
                bad.append({"pools": d, "events": j.events})
    for j in jobs[2 * D:]:
        if _table_held(j, rows):
            bad.append({"pools": "wan", "events": j.events})
    if int(jobs[0].step) != 0:
        bad.append({"pools": "step"})
    timed = {}
    p = params["lan_1m"]
    for rows in (512, 30, 1):
        j = _table_job(p, prng.key(5), 1000, rows, False, cursor=17,
                       ring=256)
        fill = functools.partial(round_table.fill, [j], rows)
        if _parent_libs() is not None:
            with _parent_kernels():
                fill()
            if _table_held(j, rows):
                bad.append({"parent": rows})
        turns = _turns(fill, graph_ms)
        ms = turns["ms"]
        eager_ms = cuda_ms(fill, 50)
        host = _table_job(p, prng.key(5), 1000, rows, False, cursor=17,
                          ring=256)
        plain = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            round_table.fill_ref([host], rows)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t1) * 1e3)
        ops = rows * _table_hashes(p, False) * HASH_OPS
        nbytes = rows * (j.table.shape[1] + 1) * 4 + 12
        op_ms = ops / INT32_OPS_PER_S * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        timed[rows] = {**turns, "eager_ms": eager_ms,
                       "plain_ms": sum(plain) / len(plain),
                       "plain_ms_each": plain, "hashes": ops // HASH_OPS,
                       "bytes": nbytes, "bound_ms": max(op_ms, byte_ms),
                       "bound_by": "operations" if op_ms >= byte_ms
                       else "bytes", "share_of_bound": max(op_ms, byte_ms)
                       / ms}
        if _table_held(j, rows) or _table_held(host, rows):
            bad.append({"timed": rows})
    res = {"phase": "table", "draws": draws, "held": held,
           "launches": round_table.launches - launches0,
           "pools_launches": pools_launches, "tolerance": 0,
           "max_abs_err": 0 if not bad else None, "mismatched": bad,
           "timed": timed, "seconds": time.perf_counter() - t0}
    emit(res)
    if bad or pools_launches != 1:
        raise AssertionError(f"table: {len(bad)} draws differ from the "
                             f"plain version ({bad[:4]}), "
                             f"{pools_launches} launches for the pools")
    return res


# The toy loop's forms (round slots an iteration, the slot's node type):
# (a) the older form, an IF node a variant, one round an iteration; (b)
# one SWITCH node a round; (c) U rounds an iteration, each slot of the
# better type of (a) and (b).
TOY_FORMS = {"a": (1, "if"), "b": (1, "switch")}
TOY_SLOTS = (2, 4, 8)
TOY_VARIANTS = (2, 10)
TOY_CHUNKS = (512, 4)  # a whole table; the plane's chunk
# A loop iteration's loop kernel reads the rounds left (4) and the step
# (8), writes the rounds left (4) and adds one to its run counter (16); a
# round taken reads its code (4) and adds one to its run counter (16).
LOOP_ITERATION_BYTES, LOOP_ROUND_BYTES = 32, 20


# The loops of one round ``loop_nesting`` times: (slots, variants).
LOOP_NESTS = ((8, 1), (8, 2), (8, 4), (1, 2), (2, 2), (4, 2))


def _toy_loop(codes: list, u: int = 1, ifs: bool = False):
    """A loop of toy rounds over ``codes`` on the card
    (``round_graph_loop_toy``: ``u`` round slots an iteration, SWITCH
    nodes or with ``ifs`` an IF node a variant a slot) and its buffers:
    ``(run(n, column) -> (held, rounds, loop kernels), launch_ms(n,
    column), close())``; ``run`` launches it on a chunk of ``n`` rounds of
    ``column``, and ``launch_ms`` times launches, each held like ``run``'s:
    every round's body, the step, the rounds left and the runs (the loop
    kernels' among them) against ``program.loop_ref``."""
    from consul_tpu_torch.gossip import program
    lib = program._lib()
    rows = program.TABLE_ROWS
    col = torch.zeros(rows, dtype=torch.int32, device="cuda")
    left = torch.zeros(1, dtype=torch.int32, device="cuda")
    step = torch.zeros(1, dtype=torch.int64, device="cuda")
    runs = torch.zeros(program.LOOP_WORDS, dtype=torch.int64, device="cuda")
    order = torch.full((rows + 1,), -1, dtype=torch.int32, device="cuda")
    args = program._LoopArgs(left.data_ptr(), step.data_ptr(),
                             col.data_ptr(), runs.data_ptr(), rows,
                             len(codes), u, int(ifs))
    for b, c in enumerate(codes):
        args.code[b] = c
    graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
    program._check(lib.round_graph_loop_toy(ctypes.addressof(args),
                                            order.data_ptr(),
                                            ctypes.byref(graph),
                                            ctypes.byref(exe)),
                   "building the toy loop")
    stream = torch.cuda.current_stream().cuda_stream

    def reset(n, column):
        col.copy_(column)
        left.fill_(n)
        step.zero_()
        runs.zero_()
        order.fill_(-1)

    def plain(n, column) -> tuple:
        h = [column.clone(), torch.tensor([n], dtype=torch.int32),
             torch.zeros(1, dtype=torch.int64),
             torch.zeros(program.LOOP_WORDS, dtype=torch.int64)]
        its = program.loop_ref(codes, *h, u=u)
        return [b for it in its for b in it], h, len(its)

    def held(want) -> bool:
        taken, h, _ = want
        got = order.cpu().tolist()
        k = len(taken)
        return (got[:k] == taken and all(x == -1 for x in got[k:])
                and int(left) == int(h[1]) and int(step) == int(h[2])
                and torch.equal(runs.cpu(), h[3]))

    def run(n: int, column) -> tuple:
        want = plain(n, column)
        reset(n, column)
        program._check(lib.round_graph_launch(exe, stream), "the toy loop")
        torch.cuda.synchronize()
        return held(want), len(want[0]), want[2]

    def launch_ms(n: int, column, reps: int = 20) -> tuple:
        """Mean ms a launch, and the launches that differ from the plain
        version."""
        want, out, bad = plain(n, column), [], 0
        for _ in range(reps):
            reset(n, column)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            program._check(lib.round_graph_launch(exe, stream),
                           "the toy loop")
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
            bad += not held(want)
        return sum(out) / len(out), bad

    return run, launch_ms, lambda: lib.round_graph_destroy(graph, exe)


def _toy_checks(codes: list, col, u: int, ifs: bool) -> list:
    """A toy form with 10 variants against ``loop_ref``: chunks of 0, 1,
    u - 1, u, u + 1, 511 and 512 rounds (512 twice from one executable),
    each running ceil(n / u) loop kernels, and a code the loop was not
    given at the first, a middle and the last slot of the 38th iteration;
    what differs."""
    from consul_tpu_torch.gossip import kernel, program
    run, _, close = _toy_loop(codes, u, ifs)
    bad = []
    for n in sorted({0, 1, max(u - 1, 0), u, u + 1, 511, 512}) + [512]:
        ok, k, its = run(n, col)
        if not ok or k != n or its != max(1, -(-n // u)):
            bad.append(f"u={u} ifs={ifs}: {n} rounds ({k}, {its} kernels)")
    missing = next(c for c in range(kernel.VARIANT_CODES) if c not in codes)
    for slot in sorted({0, u // 2, u - 1}):
        at = 37 * u + slot
        faulty = col.clone()
        faulty[at] = missing
        ok, k, its = run(program.TABLE_ROWS, faulty)
        if not ok or k != at or its != 38:
            bad.append(f"u={u} ifs={ifs}: a fault at row {at} ran {k} "
                       f"rounds in {its} kernels")
    close()
    return bad


def _toy_timed(codes: list, col, u: int, ifs: bool) -> tuple:
    """A toy form's ms a launch and a round over each of ``TOY_CHUNKS``
    and a 0-round launch, every launch held; and the launches that
    differ."""
    _, launch_ms, close = _toy_loop(codes, u, ifs)
    row, bad = {}, 0
    for n in TOY_CHUNKS:
        ms, b = launch_ms(n, col, 20 if n > 64 else 100)
        row[n] = {"launch_ms": ms, "ms_per_round": ms / n}
        bad += b
    ms, b = launch_ms(0, col, 50)
    row["empty_launch_ms"] = ms
    close()
    return row, bad + b


def loop_vs_plain() -> dict:
    """The toy loop (``_toy_loop``: a WHILE node, the loop kernel, round
    slots holding one toy round a variant) on the card in each form
    (``TOY_FORMS``: (a) an IF node a variant and one round an iteration,
    (b) one SWITCH node a round, (c) 2, 4 and 8 rounds an iteration with
    the better type of (a) and (b), by the ms a round over 512 rounds at 2
    and 10 variants): every form against its plain version
    ``program.loop_ref`` (``_toy_checks``), and each timed at 2 and 10
    variants (the churn paths', and the most a program meets) over 512
    rounds, 4 rounds and none, CUDA events around each launch, every
    launch held against ``loop_ref``.  The slots the toy favours: the
    fewest whose ms a round over 512 rounds is within 10% of 8 slots' at
    both variant counts; the program's (``program.LOOP_ROUNDS``) beside
    them.  Beside the table the plain version's host ms a round and the
    loop kernel's bytes bound a round at the program's slots."""
    from consul_tpu_torch.gossip import kernel, program
    rows = program.TABLE_ROWS
    g = torch.Generator().manual_seed(9)
    codes = torch.randperm(kernel.VARIANT_CODES, generator=g)[:10].tolist()
    cols = {V: torch.tensor(codes[:V], dtype=torch.int32)[
        torch.randint(0, V, (rows,), generator=g)] for V in TOY_VARIANTS}
    bad, table, wrong = [], {}, 0

    def form(name, u, kind):
        nonlocal wrong
        ifs = kind == "if"
        bad.extend(_toy_checks(codes, cols[10], u, ifs))
        table[name] = {"slots": u, "node": kind}
        for V in TOY_VARIANTS:
            row, b = _toy_timed(codes[:V], cols[V], u, ifs)
            table[name][V] = row
            wrong += b

    for name, (u, kind) in TOY_FORMS.items():
        form(name, u, kind)

    def per_round(name):
        return [table[name][V][rows]["ms_per_round"] for V in TOY_VARIANTS]

    better = ("switch" if sum(per_round("b")) <= sum(per_round("a"))
              else "if")
    for u in TOY_SLOTS:
        form(f"c{u}", u, better)
    top = per_round(f"c{TOY_SLOTS[-1]}")
    by_slots = {1: "b" if better == "switch" else "a",
                **{u: f"c{u}" for u in TOY_SLOTS}}
    favoured = min(u for u, name in by_slots.items()
                   if all(t <= 1.1 * t8
                          for t, t8 in zip(per_round(name), top)))
    h = [cols[2].clone(), torch.tensor([rows], dtype=torch.int32),
         torch.zeros(1, dtype=torch.int64), None]
    t0 = time.perf_counter()
    program.loop_ref(codes[:2], *h)
    plain_ms = (time.perf_counter() - t0) * 1e3 / rows
    U = program.LOOP_ROUNDS
    bound_ms = (LOOP_ITERATION_BYTES / U + LOOP_ROUND_BYTES) \
        / HBM_BYTES_PER_S * 1e3
    mine = table[by_slots[U]]
    res = {"phase": "loop_kernel", "rows": rows, "tolerance": 0,
           "max_abs_err": 0 if not (bad or wrong) else None,
           "mismatched": bad, "timed_launches_differing": wrong,
           "toy": table, "better_node": better,
           "favoured_slots": favoured, "program_slots": U,
           "ms_per_round": mine[2][rows]["ms_per_round"],
           "empty_launch_ms": mine[2]["empty_launch_ms"],
           "plain_ms_per_round": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes"}
    emit(res)
    if bad or wrong:
        raise AssertionError(f"loop_kernel: the loop differs from "
                             f"loop_ref in {bad}, {wrong} timed launches")
    return res


def loop_nesting() -> dict:
    """What the nesting costs (``round_graph_nest``): a healthy 1M round's
    joined graph (the ring, banks and trace threaded, as round_program's
    healthy case runs it) launched from the host, the same graph inside
    one IF node, and inside a WHILE node's one iteration then an IF node;
    and beside them the same round as loops run it (``LOOP_NESTS``:
    ``round_graph_loop_build`` with u slots over v variants whose bodies
    all hold it, a column naming the first at every row, and the same
    over every variant the program captured: one launch of 30 rounds; the
    host ms of each graph launch beside it), and the
    program's own rounds over rows 0-29 of its table (the variants the
    call met there) and over the first 30 rows that all name the round's
    variant: one launch of its loop, and a replay a round.  Turns of 30
    rounds, CUDA events around each turn; each turn must advance the row
    counter by 30.  The graph's choosers and the one-round loops count
    into scratch buffers; the program's rounds are counted as a call
    counts them, and settled."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel, program
    lib = program._lib()
    rows = program.TABLE_ROWS
    p, fail_t, kw, st0 = _rp_inputs(0, None, rows)
    # A whole table: every row of the program's table is a real round's.
    kernel.run_rounds(st0, prng.key(42), fail_t, p, rows, trace=True,
                      flight=kernel.init_flight(), hist=kernel.init_hist(),
                      **kw)
    torch.cuda.synchronize()
    prog = next(reversed(program._programs.values()))
    code = int(kernel.variant_codes(p, None, int(st0.round), 1)[0])
    g = prog.graphs[kernel.variant_of(code)]
    scratch = torch.zeros(program.MAX_BRANCHES, dtype=torch.int64,
                          device="cuda")
    choices = (program._Choice * max(1, len(g.groups)))(
        *(q.args(scratch) for q in g.groups))
    join = program._Join(g._segs, g._group_of, len(g.segs),
                         ctypes.cast(choices, ctypes.c_void_p),
                         len(g.groups), code)
    names = {0: "host_graph", 1: "if_node", 2: "while_if"}
    execs = {}
    for depth in names:
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        program._check(lib.round_graph_nest(ctypes.byref(join), depth,
                                            ctypes.byref(graph),
                                            ctypes.byref(exe)),
                       "building a nesting")
        execs[names[depth]] = (graph, exe)
    # The round in loops of u slots and v variants, all v bodies the same
    # joined round, the column naming the first at every row.
    left = torch.zeros(1, dtype=torch.int32, device="cuda")
    col = torch.full((rows,), code, dtype=torch.int32, device="cuda")
    runs = torch.zeros(program.LOOP_WORDS, dtype=torch.int64, device="cuda")
    others = [c for c in range(kernel.VARIANT_CODES) if c != code]
    for u, v in LOOP_NESTS:
        joins = (program._Join * v)(*(
            program._Join(g._segs, g._group_of, len(g.segs),
                          ctypes.cast(choices, ctypes.c_void_p),
                          len(g.groups), c) for c in [code] + others[:v - 1]))
        args = program._LoopArgs(left.data_ptr(), prog.step.data_ptr(),
                                 col.data_ptr(), runs.data_ptr(), rows, 0, u)
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        program._check(lib.round_graph_loop_build(
            ctypes.cast(joins, ctypes.c_void_p), v, ctypes.byref(args),
            ctypes.byref(graph), ctypes.byref(exe)),
            "building a loop of one round")
        execs[f"loop_u{u}_v{v}"] = (graph, exe)
    # The program's variants' rounds (every variant it captured, as its
    # loop holds them) in a loop of its slots, counting into scratch.
    mine = {kernel.variant_code(vv): gg for vv, gg in prog.graphs.items()}
    keep = []
    for c, gg in sorted(mine.items()):
        ch = (program._Choice * max(1, len(gg.groups)))(
            *(q.args(scratch) for q in gg.groups))
        keep.append((ch, program._Join(gg._segs, gg._group_of, len(gg.segs),
                                       ctypes.cast(ch, ctypes.c_void_p),
                                       len(gg.groups), c)))
    joins = (program._Join * len(keep))(*(j for _, j in keep))
    args = program._LoopArgs(left.data_ptr(), prog.step.data_ptr(),
                             col.data_ptr(), runs.data_ptr(), rows, 0,
                             program.LOOP_ROUNDS)
    graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
    program._check(lib.round_graph_loop_build(
        ctypes.cast(joins, ctypes.c_void_p), len(keep), ctypes.byref(args),
        ctypes.byref(graph), ctypes.byref(exe)),
        "building a loop of the program's variants")
    execs["loop_program_variants"] = (graph, exe)
    stream = torch.cuda.current_stream().cuda_stream
    # The program's own rounds over 30 rows of the table (its variants
    # there): one loop launch, and a replay a round (its counts kept, as
    # a call keeps them, and settled below); over rows 0-29, and over the
    # first 30 rows that all name the round's variant.
    column = prog.variant.cpu().numpy()
    uniform = next(w for w in range(rows - 29)
                   if (column[w:w + 30] == code).all())
    starts = {"": 0, "_one_variant": uniform}

    host = collections.defaultdict(list)  # host ms a graph launch

    def launches(name):
        for _ in range(1 if name.startswith("loop") else 30):
            t0 = time.perf_counter()
            program._check(lib.round_graph_launch(execs[name][1], stream),
                           "a nesting")
            host[name].append((time.perf_counter() - t0) * 1e3)

    def program_rounds(w, replays):
        prog.left.fill_(30)
        prog._rounds(column[w:w + 30], replays)

    cases = {name: (functools.partial(launches, name), 0) for name in execs}
    for suffix, w in starts.items():
        cases[f"program_loop{suffix}"] = (
            functools.partial(program_rounds, w, False), w)
        cases[f"program_replays{suffix}"] = (
            functools.partial(program_rounds, w, True), w)
    times = {k: [] for k in cases}
    calls = {k: [] for k in cases}  # host ms a turn's calls
    bad = []
    for turn in range(6):
        for name in (list(cases) if turn % 2 == 0
                     else reversed(list(cases))):
            run, w = cases[name]
            prog.step.fill_(w)
            left.fill_(30)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            run()
            calls[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            if int(prog.step) != w + 30:
                bad.append(f"{name}: step {int(prog.step)}")
            if name.startswith("loop") and int(left) != 0:
                bad.append(f"{name}: {int(left)} rounds left")
            if turn:  # the first turn warms each up
                times[name].append(start.elapsed_time(end) / 30)
    for graph, exe in execs.values():
        lib.round_graph_destroy(graph, exe)
    _settle()
    if int(runs[code]) != 6 * 30 * (len(LOOP_NESTS) + 1):
        bad.append(f"loops: {int(runs[code])} rounds run")
    res = {"phase": "loop_nesting", "n": p.n, "variant_code": code,
           "codes_rows_0_29": column[:30].tolist(),
           "one_variant_rows_from": uniform,
           "ms_per_round": {k: sum(v) / len(v) for k, v in times.items()},
           "ms_per_round_each_turn": times,
           "launch_host_ms": {k: sum(v) / len(v) for k, v in host.items()},
           "turn_host_ms": {k: sum(v) / len(v) for k, v in calls.items()},
           "mismatched": bad}
    emit(res)
    if bad:
        raise AssertionError(f"loop_nesting: {bad}")
    return res


@contextlib.contextmanager
def _per_round_replays():
    """While the block runs, the round programs run each chunk as a replay
    a round (``RoundProgram.run(replays=True)``: the loop's plain
    version) in place of the loop."""
    from consul_tpu_torch.gossip import program
    run = program.RoundProgram.run
    program.RoundProgram.run = functools.partialmethod(run, replays=True)
    try:
        yield
    finally:
        program.RoundProgram.run = run


def _loop_gate(what: str, calls: list, looped: bool = True) -> dict:
    """The graph, table and loop kernel launches since the last
    ``_reset_counts`` on a single-pool path whose calls ran ``calls``
    rounds each: looped, ceil(rounds / 512) graph launches and table
    launches a call and ceil(n / U) loop kernels a chunk of n rounds
    (``program.loop_kernels``); with per-round replays a graph launch a
    round (the same tables).  Raises unless exactly so."""
    from consul_tpu_torch.gossip import program, round_table
    _settle()
    chunks = sum(-(-c // program.TABLE_ROWS) for c in calls)
    rounds = sum(calls)
    got = {"graph_launches": program.launches,
           "table_launches": round_table.launches,
           "loop_launches": program.loop_launches,
           "graph_launches_expected": chunks if looped else rounds,
           "table_launches_expected": chunks,
           "loop_launches_expected": sum(map(program.loop_kernels, calls))
           if looped else 0}
    if any(got[k] != got[f"{k}_expected"] for k in
           ("graph_launches", "table_launches", "loop_launches")):
        raise AssertionError(f"{what}: launches {got}")
    return got


def _loop_case(name: str, n: int, S: int, steps: int, seed: int):
    """A 16,000-node case of ``loop_paths``: parameters, ground truth, the
    run's keywords and its start state on the card."""
    from consul_tpu_torch.gossip import kernel, nemesis
    p = _full_path_params(n, S)
    fail, join, member0 = _full_path_inputs(n, steps, seed)
    kw = dict(trace=True, flight=kernel.init_flight(device="cuda"),
              hist=kernel.init_hist(device="cuda"),
              join_round=torch.from_numpy(join).cuda())
    if name == "partition_heal":
        sc = nemesis.build(name, n)
        fail = np.minimum(fail, sc.fail_round)
        kw.update(nem=sc.nem, join_round=torch.from_numpy(
            np.minimum(join, sc.join_round)).cuda())
    st = kernel.init_state(p, device="cuda")._replace(
        member=torch.from_numpy(member0).cuda())
    return p, torch.from_numpy(fail).cuda(), kw, st


def loop_paths(n: int, S: int, steps: int, seed: int) -> dict:
    """``run_rounds`` as the card runs it (looped) against the per-round
    replays (``_per_round_replays``) and the eager route, from one state,
    at n = 16,000 over ``steps`` rounds in one call (two chunks): churn
    with joins and the observers threaded, on 1 and 8 shards, and
    ``partition_heal`` across its window (its join rounds and window
    variants); carry and trace bit-identical, each route's launch gates
    exact (``_loop_gate``, ``_round_gate``), the variants the calls met
    and the loop's builds."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel, program
    t0 = time.perf_counter()
    rows, bad = {}, []
    for name, ndev in (("churn", None), ("churn", 8),
                       ("partition_heal", None)):
        p, fail_t, kw, st0 = _loop_case(name, n, S, steps, seed)
        outs, row = {}, {}
        for route in ("looped", "replays", "eager"):
            a = dict(kw, graphed=route != "eager")
            _reset_counts()
            builds0, build_s0 = program.loop_builds, program.loop_build_s
            with (_per_round_replays() if route == "replays"
                  else contextlib.nullcontext()):
                if ndev:
                    out = kernel.run_rounds_sharded(st0, prng.key(seed),
                                                    fail_t, p, steps,
                                                    ndev=ndev, **a)
                else:
                    out = kernel.run_rounds(st0, prng.key(seed), fail_t, p,
                                            steps, **a)
            torch.cuda.synchronize()
            outs[route] = out
            r = {"round_counts": _round_gate(f"loop {name} {route}"),
                 "tail_rounds": dict(kernel.tail_rounds),
                 "join_rounds": kernel.join_rounds}
            if route != "eager":
                r.update(_loop_gate(f"loop {name} {route}", [steps],
                                    route == "looped"),
                         loop_builds=program.loop_builds - builds0,
                         loop_build_s=program.loop_build_s - build_s0)
            row[route] = r
        variants = sorted(set(kernel.variant_codes(
            p, kw.get("nem"), 0, steps).tolist()))
        (cl, tl), (cr, tr), (ce, te) = (outs[k] for k in
                                        ("looped", "replays", "eager"))
        diverged = {"replays": _diverged(list(zip(cl, cr)) + [(tl, tr)]),
                    "eager": _diverged(list(zip(cl, ce)) + [(tl, te)])}
        key = name if ndev is None else f"{name}_{ndev}_shards"
        rows[key] = {"routes": row, "variant_codes": variants,
                     "diverged": diverged}
        if diverged["replays"] or diverged["eager"]:
            bad.append(f"{key}: {diverged}")
        if row["looped"]["tail_rounds"] != row["eager"]["tail_rounds"]:
            bad.append(f"{key}: tails {row['looped']['tail_rounds']} vs "
                       f"{row['eager']['tail_rounds']}")
        if name == "partition_heal" and len(variants) < 3:
            bad.append(f"{key}: only variants {variants}")
        del outs, p, fail_t, kw, st0
    res = {"phase": "loop_paths", "n": n, "slots": S, "steps": steps,
           "cases": rows, "seconds": time.perf_counter() - t0}
    emit(res)
    if bad:
        raise AssertionError(f"loop_paths: {bad}")
    return res


# The kernels a looped call launches, by a part of their device names,
# and the host counter of each.
LOOP_KERNELS = {"tail": "dissem_tail::tail_kernel", "probe": "probe::",
                "finish_slots": "finish_slots::",
                "fire": "finish::fire_kernel", "wipe": "finish::wipe_kernel",
                "observe": "observe::counts_kernel",
                "choose": "round_graph::choose_kernel",
                "loop": "round_graph::loop_kernel",
                "table": "round_table::table_kernel"}


def _loop_counted() -> dict:
    from consul_tpu_torch.gossip import (finish, finish_slots, fused,
                                         observe, probe, program,
                                         round_table)
    _settle()
    return {"tail": fused.launches, "probe": probe.launches,
            "finish_slots": finish_slots.launches,
            "fire": finish.fire_launches, "wipe": finish.wipe_launches,
            "observe": observe.launches,
            "choose": program.choose_launches,
            "loop": program.loop_launches, "table": round_table.launches}


def loop_profiled(n: int, S: int, steps: int, seed: int) -> dict:
    """A looped call (``_loop_case``'s churn at 16,000, the observers
    threaded, ``steps`` rounds: two chunks) under the profiler: each
    kernel the profiler saw run equals the launches the host counted for
    the call, settled (``LOOP_KERNELS``).  The loop is built again after
    a profiler session first (``profile_round.fresh_loops``); a session
    before that, on the loop built before any session in the process, is
    recorded beside it, ungated."""
    from torch.profiler import ProfilerActivity, profile

    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel
    from consul_tpu_torch.profile_round import device_kernels, fresh_loops
    p, fail_t, kw, st0 = _loop_case("churn", n, S, steps, seed)

    def run():
        kernel.run_rounds(st0, prng.key(seed), fail_t, p, steps, **kw)
        torch.cuda.synchronize()

    def profiled() -> dict:
        c0 = _loop_counted()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        c1 = _loop_counted()
        rows = device_kernels(prof)
        return {k: {"profiled": sum(e.count for e in rows if name in e.key),
                    "counted": c1[k] - c0[k]}
                for k, name in LOOP_KERNELS.items()}

    run()
    before = profiled()
    fresh_loops()
    run()
    after = profiled()
    res = {"phase": "loop_profiled", "n": n, "steps": steps,
           "loop_built_before_any_session": before,
           "loop_built_after_a_session": after}
    emit(res)
    bad = [k for k, r in after.items()
           if r["profiled"] != r["counted"] or r["counted"] == 0]
    if bad:
        raise AssertionError(f"loop_profiled: the profiler's kernels differ "
                             f"from the host's counts in {bad}: {after}")
    return res


def loop_phase() -> dict:
    """The loop's checks: first the nested graph (a WHILE node whose body
    holds round slots' SWITCH nodes holding a cond's IF node holding a
    captured segment with a programmatic edge: the tail then decide,
    ``pdl_check`` in the loop's form), then the toy loop's forms against
    their plain version and timed (``loop_vs_plain``), the nesting's cost
    (``loop_nesting``), the table kernel against its host twin, the
    looped paths at 16,000, and a looped call's kernels as the profiler
    saw them against the host's counts."""
    nested = pdl_check(1, looped=True)
    emit({"phase": "loop_nested", **nested})
    if not (nested["kept"] and nested.get("held")):
        raise AssertionError(f"loop: the nested graph did not keep and "
                             f"hold its programmatic edge: {nested}")
    return {"nested": nested, "kernel": loop_vs_plain(),
            "nesting": loop_nesting(),
            "table": table_vs_plain(), "paths": loop_paths(**LOOP_PATH),
            "profiled": loop_profiled(**LOOP_PATH)}


def round_program_phase(card_line: str) -> dict:
    """The graphed round (``gossip/program.py``: looped, and with a replay
    a round, the loop's plain version) against the eager round, in this
    call, at 1M nodes: churn on one device (with the observers threaded
    and without) and on 8 shards, healthy, ``partition_heal`` across its
    window's start.  Final state, flight ring, hist banks and the last
    block's trace bit-identical; the graphed call reads the device twice
    (round counter, flight cursor; once without the ring) whatever its
    rounds; a table launch and a graph launch a call looped, a graph
    launch a round replayed, ceil(n / U) loop kernels a looped chunk of n
    rounds;
    rounds/s of the three routes, device kernels a round and idle share
    (profiled, churn, the looped route in a fresh worker process: there
    each kernel the profiler saw run must equal the launches the wrappers
    counted), captures, their seconds and the pool's bytes."""
    from consul_tpu_torch.gossip import kernel

    cases = {"churn": (1000, None, None, True),
             "churn_no_observers": (1000, None, None, False),
             "churn_8_shards": (1000, None, 8, True),
             "healthy": (0, None, None, True),
             "partition_heal": (0, "partition_heal", None, True)}
    total = RP["warm"] + RP["block"] * RP["blocks"]
    rows, bad = {}, []
    t0 = time.perf_counter()
    for name, (ppm, scenario, ndev, observers) in cases.items():
        p, fail_t, kw, st0 = _rp_inputs(ppm, scenario, total)
        eager, graphed, replays = (
            _rp_route(p, fail_t, kw, st0, ndev, graphed=route != "eager",
                      replays=route == "replays", observers=observers)
            for route in ("eager", "graphed", "replays"))
        carry, trace = graphed.pop("carry"), graphed.pop("trace")
        diverged = {other: _diverged(list(zip(carry, r.pop("carry")))
                                     + ([(trace, r.pop("trace"))]
                                        if observers else []))
                    for other, r in (("eager", eager),
                                     ("replays", replays))}
        row = {"eager": eager, "graphed": graphed, "replays": replays,
               "diverged": diverged,
               "speedup": graphed["rounds_per_s"] / eager["rounds_per_s"],
               "speedup_over_replays": graphed["rounds_per_s"]
               / replays["rounds_per_s"]}
        if name == "churn":
            # The graphed profiles (without and with the observers, the
            # plane's route) in a fresh process: ``_rp_profile_looped``.
            with ProcessPoolExecutor(1, mp_context=multiprocessing
                                     .get_context("spawn")) as child:
                looped = child.submit(_rp_profile_looped).result()
            for route in ("eager", "graphed"):
                prof = (looped[0] if route == "graphed"
                        else _rp_profile(p, fail_t, st0, False))
                row[route].update(prof)
                if route == "graphed":
                    obs = looped[1]
                    row["graphed_observers"] = obs
                # The counts are observed, not derived from the capture:
                # each kernel the wrappers counted ran on the card.
                # The draws' kernel is not on this path (the probe tick
                # draws inside its own): none seen, none counted.
                checks = [(route, prof, k)
                          for k in ("tail", "draw", "fire", "wipe", "probe",
                                    "finish_slots")]
                if route == "graphed":
                    # The chooser node: one a looped round (no join round
                    # here), none eagerly; no set_condition left; the loop
                    # kernel one a round, the table kernel one a call.
                    checks += [(route, prof, k)
                               for k in ("choose", "loop", "table")]
                    checks += [("graphed_observers", obs, k)
                               for k in ("tail", "draw", "observe", "fire",
                                         "wipe", "probe", "finish_slots",
                                         "choose", "loop", "table")]
                    for label, pr in ((route, prof),
                                      ("graphed_observers", obs)):
                        if pr["choose_kernels_profiled"] != RP_PROFILED \
                                or pr["set_condition_kernels_profiled"]:
                            bad.append(f"{name} {label}: "
                                       f"{pr['choose_kernels_profiled']} "
                                       f"chooser kernels in {RP_PROFILED} "
                                       f"rounds, "
                                       f"{pr['set_condition_kernels_profiled']}"
                                       f" set_condition")
                elif prof["choose_kernels_profiled"] \
                        or prof["choose_launches_counted"]:
                    bad.append(f"{name} eager: a chooser ran")
                for label, pr, k in checks:
                    seen = pr[f"{k}_kernels_profiled"]
                    counted = pr[f"{k}_launches_counted"]
                    if seen != counted or (seen == 0) != (k == "draw"):
                        bad.append(f"{name} {label}: the profiler saw "
                                   f"{seen} {k} kernels for {counted} "
                                   f"counted launches")
                if prof["observe_launches_counted"] != 0:
                    bad.append(f"{name} {route}: heard_counts launched "
                               f"with no observer threaded")
        rows[name] = row
        if diverged["eager"] or diverged["replays"]:
            bad.append(f"{name}: diverged in {diverged}")
        # The round counter, and the flight cursor where the ring is
        # threaded.
        for route, r in (("graphed", graphed), ("replays", replays)):
            if r["host_syncs_per_call"] != 1 + observers:
                bad.append(f"{name} {route}: {r['host_syncs_per_call']} "
                           f"host reads a graphed call")
        # The observers' kernel: one launch a round for the trace and the
        # flight row, one a non-quiescent round for the spread, every
        # route; a chunk's graph launches and tables.
        for route, r in (("eager", eager), ("graphed", graphed),
                         ("replays", replays)):
            bad += _rp_calls_gate(name, route, r)
            if r["observe_launches"] != r["observe_launches_expected"]:
                bad.append(f"{name} {route}: {r['observe_launches']} "
                           f"heard_counts launches, expected "
                           f"{r['observe_launches_expected']}")
            # The fire pass, the wipes, the probe kernels and the finish
            # step's slot kernels at their exact counts, the matrix's
            # copies, and the caller's state left as it was.
            if _round_bad(r):
                bad.append(f"{name} {route}: finish and probe launches "
                           f"{ {k: v for k, v in r.items() if 'launches' in k} }")
            if r["matrix_copy_bytes"] != r["matrix_copy_bytes_expected"]:
                bad.append(f"{name} {route}: {r['matrix_copy_bytes']} "
                           f"matrix bytes copied, expected "
                           f"{r['matrix_copy_bytes_expected']}")
            if not r["input_unchanged"]:
                bad.append(f"{name} {route}: the caller's state changed")
        del p, fail_t, kw, st0
    res = {"phase": "round_program", "card": card_line, "n": 1_000_000,
           "slots": 64, "rounds": total, "cases": rows,
           "gathers_vs_views": _gathers_vs_views(),
           "choose_alone": choose_alone_ms(),
           "seconds": time.perf_counter() - t0}
    emit(res)
    if bad or kernel._recorder is not None:
        raise AssertionError(f"round_program: {bad}")
    return res


# -- the event flood -----------------------------------------------------------

def _events_16k(dev, p, alive, fires, seed):
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import events

    key = prng.key(seed)
    al = torch.from_numpy(alive).to(dev)
    st = events.init_events(p, slots=64, device=dev)
    covs = []
    for nodes, steps in fires:
        st = events.fire_events(st, torch.from_numpy(nodes))
        st, cov = events.run_event_rounds(st, key, al, p, steps)
        covs.append(cov)
    return st, torch.cat(covs)


def events_phase(seed: int = 21) -> dict:
    """The event flood on the card (the graphed route: the event program,
    one ``event_flood`` launch a round) against the CPU at n = 16,000,
    then its coverage gate at [64, 1M] and its time there, graphed against
    eager in this call."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import events
    from consul_tpu_torch.gossip.params import SwimParams, lan_profile

    n = 16_000
    # push/pull every 10 rounds: 30 push/pull rounds, and slots freed by
    # GC (event_ttl_rounds = 155) before the second batch fires.
    p = lan_profile(n, pushpull_every=10)
    rng = np.random.default_rng(seed)
    alive = rng.random(n) >= 0.1
    first = rng.integers(0, n, 72).astype(np.int32)
    first[[3, 17, 40]] = -1
    first[50:54] = first[10]          # repeated nodes; 69 fires > 64 slots
    second = rng.integers(0, n, 12).astype(np.int32)
    second[5] = -1
    fires = [(first, 200), (second, 100)]
    t0 = time.perf_counter()
    _reset_counts()
    st_g, cov_g = _events_16k("cuda", p, alive, fires, seed)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    flood_16k = events.launches
    st_c, cov_c = _events_16k("cpu", p, alive, fires, seed)
    diverged = _diverged([(st_g, st_c)])
    if not torch.equal(cov_g.cpu(), cov_c):
        diverged.append("coverage")
    drops = int(st_c.drops)

    # [64, 1M] with the plane's parameters (SwimParams defaults).
    N = 1_000_000
    pm = SwimParams(n=N, slots=64)
    key = prng.key(seed)
    alive_m = torch.ones(N, dtype=torch.bool, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    st = events.init_events(pm, slots=64, device="cuda")
    st = events.fire_events(st, torch.tensor([12345], dtype=torch.int32))
    st, cov = events.run_event_rounds(st, key, alive_m, pm,
                                      pm.event_ttl_rounds)
    trace = cov[:, 0].cpu().tolist()
    reached = next((r + 1 for r, c in enumerate(trace) if c >= 0.99), None)
    st = events.fire_events(st, torch.from_numpy(
        rng.integers(0, N, 64).astype(np.int32)))
    # The event round at [64, 1M], 64 live events: graphed (replays of
    # the event program) and eager (the plain version) from one state,
    # each a call of 100 rounds ending in a device->host read, timed by
    # CUDA events, after a warm-up call each.
    timed, outs = {}, {}
    for graphed in (True, False):
        events.run_event_rounds(st, key, alive_m, pm, 2, graphed=graphed)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs[graphed] = events.run_event_rounds(st, key, alive_m, pm, 100,
                                                graphed=graphed)
        int(outs[graphed][0].round)
        end.record()
        end.synchronize()
        timed[graphed] = start.elapsed_time(end) / 100
    diverged_1m = _diverged([(outs[True][0], outs[False][0])])
    if not torch.equal(outs[True][1], outs[False][1]):
        diverged_1m.append("coverage")
    del outs
    res = {"phase": "events", "n": n, "slots": 64, "rounds": 300,
           "drops": drops, "cuda_s": cuda_s, "diverged": diverged,
           "flood_launches_16k_card": flood_16k,
           "n_1m": N, "event_ttl_rounds": pm.event_ttl_rounds,
           "coverage_trace_1m": trace, "rounds_to_coverage_99": reached,
           "event_round_ms_1m": timed[True],
           "event_round_ms_1m_eager": timed[False],
           "diverged_1m_graphed_vs_eager": diverged_1m,
           "max_memory_allocated_1m": torch.cuda.max_memory_allocated()}
    emit(res)
    if diverged or diverged_1m:
        raise AssertionError(f"event floods diverged: card vs CPU in "
                             f"{diverged}, graphed vs eager at 1M in "
                             f"{diverged_1m}")
    if flood_16k != 300:
        raise AssertionError(f"the card's 300 event rounds made {flood_16k} "
                             f"flood launches")
    if drops == 0:
        raise AssertionError("the 16,000-node flood overflowed no slot")
    if reached is None:
        raise AssertionError(f"one event did not reach 0.99 of 1M nodes "
                             f"within {pm.event_ttl_rounds} rounds: {trace}")
    return res


# -- cross-validation against the SWIM oracle ----------------------------------

def _recorded() -> dict:
    """CROSSVAL.json: the reference's published cross-validation rows."""
    return json.loads((ROOT / "CROSSVAL.json").read_text())


def _row_diff(row: dict, ref: dict) -> list:
    """Keys of ``ref`` (but ``wall_s``) whose value ``row`` does not
    equal."""
    return [k for k in ref if k != "wall_s" and row.get(k) != ref[k]]


def _kernel_fields_diff(card: dict, full: dict) -> list:
    """Fields of a kernel-only row (``oracle=False``) that differ from the
    same config's row with the oracle (``full``): of each per-model pair,
    only the kernel's."""
    out = []
    for k, v in full.items():
        if k in ("wall_s", "relative_error", "oracle"):
            continue
        if isinstance(v, dict) and "kernel" in v:
            if card[k]["kernel"] != v["kernel"]:
                out.append(k)
        elif card[k] != v:
            out.append(k)
    return out


def _seed0_cpu() -> tuple:
    """Seed 0 of crossval's 10,000-node config on one device, the CPU, in
    a worker process."""
    from consul_tpu_torch.gossip import crossval
    torch.set_num_threads(1)
    p, fail_at, steps = crossval.config_inputs(10000, 16)
    return crossval.kernel_event_latencies(p, fail_at, steps, 0,
                                           device="cpu")


def crossval_phase(pool, cpu_seed0) -> dict:
    """The port's detection statistics on the card against CROSSVAL.json:
    ``run_config`` at n = 1,000 (the oracle's 8 seeds in the CPU workers)
    and 10,000 (kernel only; the oracle's recorded numbers stand in), seed
    0 at 10,000 on 8 shards of the card against the same seed on one
    device (``cpu_seed0``: the future of its CPU worker), then
    ``run_join_config`` and ``run_event_config`` (oracles in the
    workers).  Every compared field must equal the record."""
    from consul_tpu_torch.gossip import (crossval, events, fused, kernel,
                                         observe, program)

    rec = _recorded()
    t0 = time.perf_counter()
    _reset_counts()
    bad = []
    row1k = crossval.run_config(1000, 16, 8, device="cuda", executor=pool)
    bad += [f"1k.{k}" for k in _row_diff(row1k, rec["configs"][0])]
    row10k = crossval.run_config(10000, 16, 8, oracle=False, device="cuda")
    bad += [f"10k.{k}" for k in _kernel_fields_diff(row10k,
                                                     rec["configs"][1])]
    p, fail_at, steps = crossval.config_inputs(10000, 16)
    _settle()
    merges0 = fused.merge_launches
    eight = crossval.kernel_event_latencies(p, fail_at, steps, 0, ndev=8,
                                            device="cuda")
    _settle()
    merges = fused.merge_launches - merges0
    one = cpu_seed0.result()
    if one != eight or merges == 0:
        bad.append("10k seed 0 on 8 shards")
    join = crossval.run_join_config(1000, 8, 8, 4, device="cuda",
                                    executor=pool)
    bad += [f"join.{k}" for k in _row_diff(join, rec["join_churn"])]
    ev = [crossval.run_event_config(n, 4, device="cuda", executor=pool)
          for n in (1000, 10000)]
    for row, ref in zip(ev, rec["event_convergence"]):
        bad += [f"event{row['n']}.{k}" for k in _row_diff(row, ref)]
    _settle()
    recorded10k = rec["configs"][1]
    res = {"phase": "crossval", "seconds": time.perf_counter() - t0,
           "configs": [row1k, {
               **row10k,
               "refmodel": "recorded",
               "detection_latency_rounds": {
                   "kernel": row10k["detection_latency_rounds"]["kernel"],
                   "refmodel": recorded10k["detection_latency_rounds"][
                       "refmodel"]},
               # The kernel side equals the record's, so the record's
               # errors against its oracle hold.
               "relative_error": recorded10k["relative_error"]}],
           "seed0_10k_8_shards": {"latencies": eight[0],
                                  "equal_to_one_device": one == eight,
                                  "merge_launches": merges},
           "join_churn": join, "event_convergence": ev,
           "dissem_launches": fused.launches,
           "merge_launches": fused.merge_launches, **_draws(),
           "observe_launches": observe.launches, **_round_counts(),
           "graph_launches": program.launches,
           "loop_launches": program.loop_launches,
           "round_rounds": program.round_replays,
           "host_syncs": kernel.host_syncs, "diverged": bad}
    emit(res)
    _draw_gate("crossval", res, 0)
    _round_gate("crossval")
    # Every membership round threads the trace (no hist): the trace's
    # holders are one launch of the observers' kernel a round, every
    # round looped (the loop kernels a chunk held to the device's own
    # count by every settle).
    rounds = program.round_replays
    if rounds != program.looped_rounds or program.loop_launches == 0:
        raise AssertionError(f"crossval: {program.looped_rounds} of "
                             f"{rounds} rounds looped in "
                             f"{program.loop_launches} loop kernels")
    if observe.launches == 0 or observe.launches != rounds:
        raise AssertionError(f"crossval: {observe.launches} heard_counts "
                             f"launches in {rounds} rounds")
    if bad:
        raise AssertionError(f"crossval differs from CROSSVAL.json in {bad}")
    if fused.launches == 0:
        raise AssertionError("crossval launched no fused_dissem")
    return res


NEMX = dict(n=256, seeds=2)


def _nemx_cpu(name: str, n: int, seeds: int) -> dict:
    """A catalog scenario's cross-validation row from the port on the
    CPU, in a worker process."""
    from consul_tpu_torch.gossip import crossval
    torch.set_num_threads(1)
    return crossval.run_nemesis_config(name, n, seeds, device="cpu")


def crossval_nemesis_phase(cpu_rows: dict, n: int, seeds: int) -> dict:
    """Every catalog scenario through ``run_nemesis_config`` on the card,
    kernel side only, against the port's whole row from a CPU worker
    (``cpu_rows``: scenario -> future; the oracle runs there, once):
    every kernel field equal, and the reference suite's gates on
    ``partition_heal`` and ``flapping``."""
    from consul_tpu_torch.gossip import crossval, fused
    from consul_tpu_torch.gossip.nemesis import names

    t0 = time.perf_counter()
    _reset_counts()
    rows, bad, card_s, wait_s = {}, [], {}, 0.0
    for name in names():
        t1 = time.perf_counter()
        card = crossval.run_nemesis_config(name, n, seeds, oracle=False,
                                           device="cuda")
        card_s[name] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rows[name] = cpu_rows[name].result()
        wait_s += time.perf_counter() - t1
        bad += [f"{name}.{k}" for k in _kernel_fields_diff(card, rows[name])]
    ph, fl = rows["partition_heal"], rows["flapping"]
    for model in ("kernel", "refmodel"):
        if not (ph["false_dead"][model] > 0
                and ph["member_frac_end"][model] >= 0.95):
            bad.append(f"partition_heal gate ({model})")
        if not (fl["completeness"][model] >= 0.9
                and fl["member_frac_end"][model] >= 0.95):
            bad.append(f"flapping gate ({model})")
    if ph["kernel_slot_drops"] != 0:
        bad.append("partition_heal slot drops")
    if not (fl["relative_error"]["p50"] is not None
            and fl["relative_error"]["p50"] <= 0.25):
        bad.append("flapping p50 relative error")
    _settle()
    res = {"phase": "crossval_nemesis", "n": n, "seeds": seeds,
           "seconds": time.perf_counter() - t0, "card_s": card_s,
           "cpu_wait_s": wait_s, "scenarios": rows,
           "dissem_launches": fused.launches,
           "drop_launches": fused.drop_launches, "diverged": bad}
    emit(res)
    if bad:
        raise AssertionError(f"crossval_nemesis: {bad}")
    return res


def crossval_1m_phase() -> dict:
    """The first distribution of detection latency at 1M nodes on the
    card: CROSSVAL.json's kernel-only push/pull row at the BASELINE's n,
    gated on its own criterion (the Lifeguard envelope)."""
    from consul_tpu_torch.gossip import crossval, fused, kernel

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    row = crossval.run_config(1_000_000, 16, 2, pushpull=True, oracle=False,
                              device="cuda")
    wall = time.perf_counter() - t0
    _settle()
    _, _, steps = crossval.config_inputs(1_000_000, 16, pushpull=True)
    lo, hi = row["lifeguard_envelope_rounds"]
    lat = row["detection_latency_rounds"]["kernel"]
    res = {"phase": "crossval_1m", "row": row, "steps_per_seed": steps,
           "rounds": 2 * steps, "seconds": wall,
           "rounds_per_s": 2 * steps / wall,
           "mean": lat["mean"], "p50": lat["p50"], "p99": lat["p99"],
           "envelope": [lo, hi], "dissem_launches": fused.launches,
           "host_syncs_per_round": kernel.host_syncs / (2 * steps),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(res)
    if not (row["completeness"]["kernel"] == 1.0
            and row["false_dead"]["kernel"] == 0
            and row["kernel_slot_drops"] == 0
            and 0.8 * lo <= lat["p99"] <= hi):
        raise AssertionError(f"crossval_1m outside its gates: {row}")
    if fused.launches == 0:
        raise AssertionError("crossval_1m launched no fused_dissem")
    return res


# -- multi-DC gossip ---------------------------------------------------------------

MDC = dict(D=3, n=16_000, S=64, steps=200, seed=17)


def _mdc_run(D: int, n: int, S: int, steps: int, seed: int, hot: int,
             dev: str, ndev: int = 0):
    """``steps`` multi-DC rounds with hist banks: LAN failures in every DC
    (servers included in the last), a WAN server failure, one event fired
    in DC 0 before the run and, halfway, one in DC 2 and one past the
    last free slot.  Returns (state, hist, coverage) as numpy."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import convert
    from consul_tpu_torch.gossip import multidc as md

    rng = np.random.default_rng(seed)
    lan_fail = np.full((D, n), NEVER, np.int32)
    for d in range(D):
        ids = rng.choice(np.arange(1 if d == D - 1 else 3, n), 6, False)
        lan_fail[d, ids] = rng.integers(5, steps - 40, 6)
    wan_fail = np.full((D * 3,), NEVER, np.int32)
    wan_fail[4] = 30
    p = md.make_params(D, n, event_slots=2, slots=S, hot_slots=hot,
                       lan_devices=ndev)
    st = md.fire_in_dc(md.init_multidc(p, device=dev), 0, n // 3, p)
    hb = md.init_multidc_hist(p, device=dev)
    covs = []
    for half in range(2):
        if half:
            st = md.fire_in_dc(st, 2, (n * 5) // 16, p)
            st = md.fire_in_dc(st, 1, 77, p)
        (st, hb), cov = md.run_multidc_rounds(st, prng.key(seed), lan_fail,
                                              wan_fail, p, steps // 2,
                                              lan_hist=hb, device=dev)
        covs.append(cov)
    return (convert.multidc_to_numpy(st), convert.hist_banks_to_numpy(hb),
            torch.cat(covs).cpu().numpy())


def _mdc_cpu(hot: int, D: int, n: int, S: int, steps: int, seed: int):
    """multidc_full_path's run on the CPU, in a worker process."""
    torch.set_num_threads(1)
    return _mdc_run(D, n, S, steps, seed, hot, "cpu")


def _mdc_diff(a, b) -> list:
    (sa, ha, ca), (sb, hb, cb) = a, b
    out = [f"{pool}.{f}" for pool in sa for f in sa[pool]
           if sa[pool][f].dtype != sb[pool][f].dtype
           or not np.array_equal(sa[pool][f], sb[pool][f])]
    out += [f"hist.{f}" for f in ha if not np.array_equal(ha[f], hb[f])]
    if ca.dtype != cb.dtype or not np.array_equal(ca, cb):
        out.append("coverage")
    return out


def _mdc_lan_busy() -> int:
    """The non-quiescent rounds of the multi-DC programs' LAN pools since
    the last ``_reset_counts``: each LAN pool's program settled alone,
    before ``_settle`` folds in the rest (the WAN pool's rounds too)."""
    from consul_tpu_torch.gossip import kernel
    from consul_tpu_torch.gossip import multidc as md

    def busy():
        return kernel.tail_rounds["hot"] + kernel.tail_rounds["full"]

    before = busy()
    for prog in md._programs.values():
        for lan in prog.lan:
            lan.settle()
    return busy() - before


def multidc_full_path(cpu: dict, D: int, n: int, S: int, steps: int,
                      seed: int) -> dict:
    """The multi-DC round on the card against the CPU workers' runs (hot
    tier off and on), and with each DC's LAN pool on 8 column shards
    against the card's single-device run: every field of the state, the
    hist banks and the coverage trace bit-identical."""
    from consul_tpu_torch.gossip import events, fused, kernel, observe
    from consul_tpu_torch.gossip import multidc as md
    from consul_tpu_torch.gossip import program, round_table

    t0 = time.perf_counter()
    runs, bad = {}, []
    for hot in (0, 8):
        _reset_counts()
        t1 = time.perf_counter()
        single = _mdc_run(D, n, S, steps, seed, hot, "cuda")
        lan_busy = _mdc_lan_busy()
        _settle()
        row = {"cuda_s": time.perf_counter() - t1,
               "lan_busy_rounds": lan_busy,
               "dissem_launches": fused.launches, **_draws(steps),
               "observe_launches": observe.launches,
               "finish": _round_counts(),
               "flood_launches": events.launches,
               "graph_launches": program.launches,
               "table_launches": round_table.launches,
               "host_syncs": kernel.host_syncs,
               "tail_rounds": dict(kernel.tail_rounds)}
        _reset_counts()
        t1 = time.perf_counter()
        sharded = _mdc_run(D, n, S, steps, seed, hot, "cuda", ndev=8)
        sharded_lan_busy = _mdc_lan_busy()
        _settle()
        md.close_programs()
        row.update(cuda_8_shards_s=time.perf_counter() - t1,
                   sharded_finish=_round_counts(),
                   sharded_lan_busy_rounds=sharded_lan_busy,
                   sharded_observe_launches=observe.launches,
                   sharded_merge_launches=fused.merge_launches,
                   sharded_dissem_launches=fused.launches,
                   sharded_tail_rounds=dict(kernel.tail_rounds))
        t1 = time.perf_counter()
        row["diverged_cpu"] = _mdc_diff(single, cpu[hot].result())
        row["cpu_wait_s"] = time.perf_counter() - t1
        row["diverged_8_shards"] = _mdc_diff(single, sharded)
        row["n_detected"] = single[0]["lan"]["n_detected"].tolist()
        row["wan_n_detected"] = int(single[0]["wan"]["n_detected"])
        row["event_drops"] = single[0]["lan_events"]["drops"].tolist()
        row["coverage_max"] = single[2].max(axis=0).tolist()
        runs[f"hot_slots={hot}"] = row
        busy = row["tail_rounds"]["hot"] + row["tail_rounds"]["full"]
        if row["diverged_cpu"] or row["diverged_8_shards"]:
            bad.append(f"hot_slots={hot}: diverged")
        if row["dissem_launches"] != busy or busy == 0:
            bad.append(f"hot_slots={hot}: fused_dissem launches "
                       f"{row['dissem_launches']} != busy rounds {busy}")
        if row["sharded_merge_launches"] == 0:
            bad.append(f"hot_slots={hot}: no fused_merge launch")
        # Every pool's round (LAN and WAN): the fire pass once and the
        # wipe twice a non-quiescent round, the wipe once more a round.
        for k in ("finish", "sharded_finish"):
            c = row[k]
            if _round_bad(c) or c["fire_launches"] == 0:
                bad.append(f"hot_slots={hot}: {k} launches {c}")
        # The LAN pools thread the hist banks: the spread is one launch
        # of the observers' kernel a non-quiescent LAN round (the WAN
        # pool threads none), on one device and on 8 shards.
        for k, lb in (("observe_launches", "lan_busy_rounds"),
                      ("sharded_observe_launches",
                       "sharded_lan_busy_rounds")):
            if row[k] != row[lb] or row[lb] == 0:
                bad.append(f"hot_slots={hot}: {row[k]} heard_counts "
                           f"launches ({k}) for {row[lb]} non-quiescent "
                           f"LAN rounds")
        if row["draw_launches"] != row["draw_calls"]:
            bad.append(f"hot_slots={hot}: {row['draw_launches']} draw "
                       f"launches for {row['draw_calls']} device draws")
        # The card's route is the graphed one: D + 1 floods, 2 D + 3
        # graph launches a round, one host read and one table launch (every
        # pool's tables) a call (two calls).
        if row["flood_launches"] != (D + 1) * steps \
                or row["graph_launches"] != (2 * D + 3) * steps \
                or row["host_syncs"] != 2 or row["table_launches"] != 2:
            bad.append(f"hot_slots={hot}: {row['flood_launches']} floods, "
                       f"{row['graph_launches']} graph launches, "
                       f"{row['host_syncs']} host reads, "
                       f"{row['table_launches']} table launches in {steps} "
                       f"rounds")
    res = {"phase": "multidc_full_path", "D": D, "n_lan": n, "slots": S,
           "steps": steps, "seconds": time.perf_counter() - t0,
           "runs": runs, "bad": bad}
    emit(res)
    if bad:
        raise AssertionError(f"multidc_full_path: {bad}")
    return res


def _mdc_route(p, lan_fail_t, wan_fail_t, key, warm: int, block: int,
               blocks: int, graphed: bool) -> tuple:
    """One route of the 1M multi-DC main path from a fresh state (one
    event fired at (dc 0, node 7)): the warm-up call, then ``blocks``
    timed calls of ``block`` rounds, each ending in a device->host read.
    Returns the route's numbers and its state after each call."""
    from consul_tpu_torch.gossip import events, fused, kernel
    from consul_tpu_torch.gossip import multidc as md
    from consul_tpu_torch.gossip import program, round_table

    total = warm + block * blocks
    # A call's tables: the host's build on the eager route, the table
    # kernel's fill (one launch for every pool) on the graphed one.
    table_s = []
    builds = {(md, "_tables"): md._tables,
              (md.round_table, "fill"): md.round_table.fill}

    def timed(fn):
        def call(*a):
            t = time.perf_counter()
            out = fn(*a)
            table_s.append(time.perf_counter() - t)
            return out
        return call

    torch.cuda.reset_peak_memory_stats()
    state = md.fire_in_dc(md.init_multidc(p), 0, 7, p)
    _reset_counts()
    cap0 = (program.captures, program.capture_s)
    for (mod, attr), fn in builds.items():
        setattr(mod, attr, timed(fn))
    try:
        t0 = time.perf_counter()
        state, cov = md.run_multidc_rounds(state, key, lan_fail_t, wan_fail_t,
                                           p, warm, graphed=graphed)
        int(state.wan.round)
        warm_s = time.perf_counter() - t0
        covs, times, states = [cov], [], [state]
        for _ in range(blocks):
            t0 = time.perf_counter()
            state, cov = md.run_multidc_rounds(state, key, lan_fail_t,
                                               wan_fail_t, p, block,
                                               graphed=graphed)
            int(state.wan.round)
            times.append(time.perf_counter() - t0)
            covs.append(cov)
            states.append(state)
    finally:
        for (mod, attr), fn in builds.items():
            setattr(mod, attr, fn)
    _settle()
    calls = 1 + blocks
    cov = torch.cat(covs)[:, :, 0].cpu().numpy()          # [T, D], slot 0
    out = {"warmup_s": warm_s, "block_s": times,
           "rounds_per_s_mean": block * blocks / sum(times),
           "rounds_per_s_best_block": block / min(times),
           "dissem_launches": fused.launches,
           "merge_launches": fused.merge_launches,
           "flood_launches": events.launches,
           "dissem_launches_per_round": fused.launches / total,
           "merge_launches_per_round": fused.merge_launches / total,
           **_draws(total), **_round_counts(),
           "tail_rounds": dict(kernel.tail_rounds),
           "host_syncs_per_call": kernel.host_syncs / calls,
           "host_syncs_per_round": kernel.host_syncs / total,
           "graph_launches_per_round": program.launches / total,
           "table_host_ms_per_call": 1e3 * sum(table_s) / len(table_s),
           "table_launches_per_call": round_table.launches / calls,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "rounds_to_coverage_99": [
               next((r + 1 for r in range(total) if cov[r, d] >= 0.99),
                    None) for d in range(p.n_dcs)],
           "coverage_end": cov[-1].tolist()}
    if graphed:
        # Captures: a RoundProgram's variant once, an EventProgram's
        # variant and the bridge once per parity of the buffer sets (32 at
        # D = 4 with push/pull in both tiers; 21 before the event programs
        # kept two sets).
        out.update(captures=program.captures - cap0[0],
                   capture_s=program.capture_s - cap0[1],
                   pool_bytes=[prog.pool_bytes
                               for prog in md._programs.values()])
        md.close_programs()
        torch.cuda.empty_cache()
    return out, states


def _mdc_round_bound(state, *truth) -> dict:
    """The least time of a multi-DC round on the card, bound by bytes:
    every pool's state (the LAN and WAN pools' belief matrices, slot
    registers and per-node vectors, the event pools' states) read once and
    written once, the ground truth (``truth``: the failure rounds) read
    once, over the memory rate."""
    from consul_tpu_torch.gossip.kernel import _leaves
    state_bytes = sum(x.numel() * x.element_size() for x in _leaves(state))
    truth_bytes = sum(x.numel() * x.element_size() for x in truth)
    total = 2 * state_bytes + truth_bytes
    return {"state_bytes": state_bytes, "round_bound_bytes": total,
            "round_bound_ms": total / HBM_BYTES_PER_S * 1e3,
            "round_bound_by": "bytes"}


def multidc_main_path(n: int = 1_000_000, dcs: int = 4, warm: int = 20,
                      block: int = 50, blocks: int = 3,
                      lan_devices: int = 0):
    """bench.py's multidc regime on the port: ``dcs`` LAN pools of
    ``n // dcs`` nodes, 3 servers each, 32 event slots, S = 64, one event
    fired at (dc 0, node 7), ``n_lan // 1000`` failures per DC past the
    servers, spaced over ``warm + block * blocks`` rounds.  Both routes
    from the same state in this call, the eager one (``graphed=False``,
    the plain version) first, then the graphed one (``MultiDCProgram``,
    the main path): rounds/s over the timed blocks, host reads a call and
    a round, graph launches a round, captures, their seconds and each
    program's pool bytes, the table's host ms a call, kernel launches.
    The two routes' states after every call must be bit-identical.
    Returns the result line (the graphed route's numbers at its top
    level) and the graphed route's states."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import multidc as md

    n_lan = n // dcs
    p = md.make_params(dcs, n_lan, n_servers=3, event_slots=32, slots=64,
                       lan_devices=lan_devices)
    n_fail = max(1, n_lan // 1000)
    lan_fail = np.full((dcs, n_lan), NEVER, np.int32)
    s0 = p.n_servers
    total = warm + block * blocks
    lan_fail[:, s0:s0 + n_fail] = ((np.arange(n_fail, dtype=np.int64)
                                    * total) // n_fail)[None, :]
    lan_fail_t = torch.from_numpy(lan_fail).cuda()
    wan_fail_t = torch.full((dcs * s0,), NEVER, dtype=torch.int32,
                            device="cuda")
    key = prng.key(42)
    t_phase = time.perf_counter()
    eager, eager_states = _mdc_route(p, lan_fail_t, wan_fail_t, key, warm,
                                     block, blocks, graphed=False)
    graphed, states = _mdc_route(p, lan_fail_t, wan_fail_t, key, warm,
                                 block, blocks, graphed=True)
    diverged = [f"call {i}: {d}" for i, (a, b) in
                enumerate(zip(eager_states, states))
                for d in _mdc_state_diff(a, b)]
    del eager_states
    state = states[-1]
    res = {"phase": ("multidc_main_path" if lan_devices <= 1
                     else "sharded_multidc_main_path"),
           "n": n, "dcs": dcs, "n_lan": n_lan, "lan_devices": lan_devices,
           "slots": 64, "event_slots": 32, "n_fail_per_dc": n_fail,
           "rounds": total, "block_rounds": block,
           "seconds": time.perf_counter() - t_phase,
           **graphed, "eager": eager, "diverged": diverged,
           "speedup": graphed["rounds_per_s_mean"]
           / eager["rounds_per_s_mean"],
           "n_detected": [int(st.n_detected) for st in state.lan],
           "n_false_dead": [int(st.n_false_dead) for st in state.lan],
           "event_n_seen_slot0": [int(ev.n_seen[0])
                                  for ev in state.lan_events],
           **_mdc_round_bound(state, lan_fail_t, wan_fail_t)}
    emit(res)
    bad = []
    if diverged:
        bad.append(f"graphed and eager diverged: {diverged[:8]}")
    for route, r in (("graphed", graphed), ("eager", eager)):
        if None in r["rounds_to_coverage_99"]:
            bad.append(f"{route}: the event did not reach 0.99 of every "
                       f"DC: {r['rounds_to_coverage_99']}")
        launched = r["merge_launches"] if lan_devices > 1 \
            else r["dissem_launches"]
        if launched == 0:
            bad.append(f"{route} launched no tail kernel")
        if r["flood_launches"] != (dcs + 1) * total:
            bad.append(f"{route}: {r['flood_launches']} flood launches in "
                       f"{total} rounds of {dcs + 1} event pools")
        # Every pool's round: the fire pass and the wipe once a
        # non-quiescent round, the wipe once more a join round.
        for k in ("fire", "wipe"):
            if r[f"{k}_launches"] != r[f"{k}_launches_expected"]:
                bad.append(f"{route}: {r[f'{k}_launches']} {k} launches, "
                           f"expected {r[f'{k}_launches_expected']}")
        # And each probe kernel once a round of every pool, each of the
        # finish step's slot kernels once a non-quiescent one.
        for k in PROBE_KERNELS:
            if r[f"probe_{k}_launches"] != (dcs + 1) * total:
                bad.append(f"{route}: {r[f'probe_{k}_launches']} probe_{k} "
                           f"launches in {total} rounds of {dcs + 1} pools")
        for k in FINISH_SLOTS_KERNELS:
            if r[f"finish_{k}_launches"] != r["fire_launches_expected"]:
                bad.append(f"{route}: {r[f'finish_{k}_launches']} "
                           f"finish_{k} launches, expected "
                           f"{r['fire_launches_expected']}")
    if graphed["host_syncs_per_call"] != 1:
        bad.append(f"{graphed['host_syncs_per_call']} host reads a graphed "
                   f"call")
    if graphed["graph_launches_per_round"] != 2 * dcs + 3:
        bad.append(f"{graphed['graph_launches_per_round']} graph launches "
                   f"a round")
    if graphed["table_launches_per_call"] != 1:
        bad.append(f"{graphed['table_launches_per_call']} table launches a "
                   f"graphed call")
    if bad:
        raise AssertionError(f"{res['phase']}: {bad}")
    _draw_gate(res["phase"], res, 0)
    _draw_gate(res["phase"] + " (eager)", eager, 0)
    return res, states


def _mdc_state_diff(a, b) -> list:
    """Fields that differ between two multi-DC states on the card."""
    pairs = ([(f"{pool}[{d}]", x, y) for pool in ("lan", "lan_events")
              for d, (x, y) in enumerate(zip(getattr(a, pool),
                                             getattr(b, pool)))]
             + [("wan", a.wan, b.wan),
                ("wan_events", a.wan_events, b.wan_events)])
    return [f"{name}: {f}" for name, x, y in pairs
            for f in _diverged([(x, y)])]


# -- the gossip plane ------------------------------------------------------------

EV_JOIN, EV_FAILED = "member-join", "member-failed"


class _Client:
    """A minimal bridge client: 4-byte big-endian length + msgpack, a
    heartbeat at the welcome's interval, every received frame kept."""

    def __init__(self, name: str):
        self.name = name
        self.frames = []
        self.beating = True
        self._tasks = []

    def send(self, msg: dict) -> None:
        raw = msgpack.packb(msg, use_bin_type=True)
        self.writer.write(struct.pack(">I", len(raw)) + raw)

    async def _read(self) -> dict:
        (ln,) = struct.unpack(">I", await self.reader.readexactly(4))
        return msgpack.unpackb(await self.reader.readexactly(ln), raw=False)

    async def start(self, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", port)
        self.send({"t": "register", "name": self.name, "addr": "127.0.0.1",
                   "port": 0, "tags": {"role": "node"}})
        self.welcome = await self._read()
        if self.welcome.get("t") != "welcome":
            raise AssertionError(f"{self.name}: {self.welcome}")
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._pump()),
                       loop.create_task(self._beat())]

    async def _pump(self) -> None:
        while True:
            self.frames.append(await self._read())

    async def _beat(self) -> None:
        period = self.welcome["hb_interval_s"]
        while self.beating:
            self.send({"t": "hb"})
            await asyncio.sleep(period)

    def members_with(self, kind: str) -> set:
        out = set()
        for f in self.frames:
            evs = (f["events"] if f["t"] == "evbatch" else
                   [f] if f["t"] == "ev" else [])
            out |= {e["node"]["name"] for e in evs if e["kind"] == kind}
        return out

    def got_user(self, name: str) -> bool:
        return any(f["t"] == "user" and f["name"] == name
                   for f in self.frames)

    async def query(self, t: str, timeout: float = 60.0, **kw) -> dict:
        seen = len(self.frames)
        self.send({"t": t, **kw})
        await _until(lambda: any(f["t"] == t for f in self.frames[seen:]),
                     timeout, f"{self.name}: {t} reply")
        return next(f for f in self.frames[seen:] if f["t"] == t)

    async def close(self) -> None:
        for task in self._tasks:
            task.cancel()
        if getattr(self, "writer", None) is not None:
            self.writer.close()


async def _until(cond, timeout: float, what: str) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout} s: {what}")
        await asyncio.sleep(0.02)
    return time.perf_counter() - t0


async def _plane_run(ndev: int, full: bool, n_clients: int = 8) -> dict:
    from consul_tpu_torch.gossip import events, fused, kernel, observe
    from consul_tpu_torch.gossip import plane as gp
    from consul_tpu_torch.gossip import program, round_table

    cfg = gp.PlaneConfig(
        bind_port=0, capacity=1024, sim_nodes=998_976, slots=64,
        event_slots=64, gossip_interval_s=0.02, probe_every=5,
        suspicion_mult=1.0, hb_lapse_s=0.3, shard_devices=ndev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    plane = gp.GossipPlane(cfg)
    t0 = time.perf_counter()
    await plane.start()
    res = {"phase": "plane", "n": plane.n_universe, "ndev": plane._ndev,
           "start_s": time.perf_counter() - t0}
    # The event-coverage observable after every event dispatch (the
    # flood's slot is recycled event_ttl_rounds after it fires).
    cov_max = {}
    event_dispatch = plane._dispatch_events

    def tracked():
        event_dispatch()
        if plane._ev_meta:
            for s, c in plane.event_coverage().items():
                cov_max[s] = max(cov_max.get(s, 0.0), c)

    plane._dispatch_events = tracked
    clients = [_Client(f"agent-{i}") for i in range(n_clients)]
    try:
        t_serve = time.perf_counter()
        await asyncio.gather(*(c.start(plane.local_addr[1]) for c in clients))
        names = {c.name for c in clients}
        res["join_s"] = await _until(lambda: all(
            c.members_with(EV_JOIN) >= names - {c.name} for c in clients),
            60, "member-join for every other client")
        if full:
            clients[0].send({"t": "event", "name": "deploy",
                             "payload": b"v2", "coalesce": True})
            res["user_event_s"] = await _until(lambda: all(
                c.got_user("deploy") for c in clients), 30,
                "the user event at every client")
            res["coverage_s"] = await _until(
                lambda: max(cov_max.values(), default=0.0) >= 0.99, 30,
                "event coverage >= 0.99")
            res["event_coverage_max"] = max(cov_max.values())
        victim, others = clients[-1], clients[:-1]
        victim.beating = False
        res["failure_s"] = await _until(lambda: all(
            victim.name in c.members_with(EV_FAILED) for c in others),
            120, f"member-failed for {victim.name} at every other client")
        res["failed_others"] = sorted(
            set().union(*(c.members_with(EV_FAILED) for c in others))
            - {victim.name})
        stats = await others[0].query("stats")
        res["rounds"] = plane._rounds_done
        res["rounds_per_s"] = plane._rounds_done / (time.perf_counter()
                                                    - t_serve)
        res["kernel"] = stats["kernel"]
        if full:
            res["members"] = len((await others[0].query("members"))
                                 ["members"])
            device = await others[0].query("device")
            disp = device["dispatch"]["round_step"]
            res["dispatch"] = {"count": disp["count"],
                               "p50_ms": disp["p50_ms"],
                               "p99_ms": disp["p99_ms"],
                               "mean_ms": disp["sum_ms"] / disp["count"]}
            res["compile_wall_s"] = device["compile"]["wall_s"]
            res["roofline"] = device["roofline"]
            res["device_rows"] = device["devices"]
            profile = await others[0].query("profile", steps=8)
            res["profile"] = {k: profile.get(k) for k in (
                "rounds", "round_ms", "device_ms_per_round",
                "roofline_utilization", "error")}
            # The card's idle share in an unprofiled dispatch: its busy
            # time per round (profiled) over the host's (dispatch mean).
            if profile.get("device_ms_per_round") is not None:
                res["device_idle_share"] = 1 - (
                    profile["device_ms_per_round"]
                    / (res["dispatch"]["mean_ms"] / gp.STEPS_PER_TICK))
    finally:
        for c in clients:
            await c.close()
        await plane.stop()
    _settle()
    # The round program's calls: one table launch and one loop launch a
    # call (a dispatch's 4 rounds), ceil(4 / U) loop kernels a call; the
    # event rounds replay a graph each.
    res.update(dissem_launches=fused.launches,
               merge_launches=fused.merge_launches,
               flood_launches=events.launches,
               observe_launches=observe.launches, **_round_counts(),
               graph_launches=program.launches,
               round_graph_launches=program.launches - events.launches,
               table_launches=round_table.launches,
               loop_launches=program.loop_launches,
               loop_launches_expected=program.loop_kernels(
                   gp.STEPS_PER_TICK) * (program.launches - events.launches),
               looped_rounds=program.looped_rounds,
               round_rounds=program.round_replays,
               tail_rounds=dict(kernel.tail_rounds),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return res


def plane_phase(ndev: int, full: bool) -> dict:
    """The plane on the card serving bridge clients; its ticker swallows
    tick errors onto stderr, so stderr is captured and searched."""
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            res = asyncio.run(_plane_run(ndev, full))
    finally:
        sys.stderr.write(err.getvalue())
    res["tick_errors"] = err.getvalue().count("[gossip-plane] tick error")
    emit(res)
    launches = res["merge_launches"] if ndev > 1 else res["dissem_launches"]
    if full and res["flood_launches"] <= 0:
        raise AssertionError("plane: the user event made no flood launch")
    # The plane threads the ring, the banks and the trace in every round
    # it runs (its dispatches and the profile query's): one launch of the
    # observers' kernel a round and one more a non-quiescent round.
    ran = sum(res["tail_rounds"].values())
    busy = res["tail_rounds"]["hot"] + res["tail_rounds"]["full"]
    if res["loop_launches"] != res["loop_launches_expected"] \
            or res["looped_rounds"] != res["round_rounds"] \
            or res["loop_launches"] == 0:
        raise AssertionError(f"plane: {res['loop_launches']} loop kernels "
                             f"(expected {res['loop_launches_expected']}) "
                             f"for {res['looped_rounds']} looped of "
                             f"{res['round_rounds']} rounds of the round "
                             f"program")
    if ran < res["rounds"] or res["observe_launches"] != ran + busy:
        raise AssertionError(f"plane: {res['observe_launches']} "
                             f"heard_counts launches in {ran} rounds "
                             f"({res['rounds']} dispatched, {busy} "
                             f"non-quiescent), expected {ran + busy}")
    # Every round it runs: the fire pass and the wipe once a
    # non-quiescent round, the wipe once more a join round.
    for k in ("fire", "wipe"):
        if res[f"{k}_launches"] != res[f"{k}_launches_expected"]:
            raise AssertionError(f"plane: {res[f'{k}_launches']} {k} "
                                 f"launches, expected "
                                 f"{res[f'{k}_launches_expected']}")
    # And each probe kernel once a round, each of the finish step's slot
    # kernels once a non-quiescent one.
    for k in PROBE_KERNELS:
        if res[f"probe_{k}_launches"] != ran:
            raise AssertionError(f"plane: {res[f'probe_{k}_launches']} "
                                 f"probe_{k} launches in {ran} rounds")
    for k in FINISH_SLOTS_KERNELS:
        if res[f"finish_{k}_launches"] != busy:
            raise AssertionError(f"plane: {res[f'finish_{k}_launches']} "
                                 f"finish_{k} launches in {busy} "
                                 f"non-quiescent rounds")
    if res["tick_errors"] or res["failed_others"] or launches <= 0:
        raise AssertionError(f"plane (shard_devices={ndev}): tick errors "
                             f"{res['tick_errors']}, failed others "
                             f"{res['failed_others']}, launches {launches}")
    if res["kernel"]["n_false_dead"] != 0:
        raise AssertionError(f"plane: n_false_dead {res['kernel']}")
    if full:
        row = res["device_rows"][0] if res["device_rows"] else {}
        if not (row.get("hbm_bytes_limit", 0) > 0
                and row.get("hbm_bytes_in_use", 0) > 0):
            raise AssertionError(f"device frame without the card's memory: "
                                 f"{res['device_rows']}")
        if res["profile"]["error"] is not None:
            raise AssertionError(f"profile frame: {res['profile']}")
    return res


async def _plane_nemesis_run(n_clients: int = 8, rounds: int = 200) -> dict:
    """The plane at universe 1M under ``partition_heal`` (window [40,
    160), then the heal) serving ``n_clients`` bridge clients, until
    ``rounds`` rounds have run."""
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip import plane as gp

    cfg = gp.PlaneConfig(
        bind_port=0, capacity=1024, sim_nodes=998_976, slots=64,
        event_slots=64, gossip_interval_s=0.02, probe_every=5,
        suspicion_mult=1.0, hb_lapse_s=0.3, shard_devices=1,
        nemesis="partition_heal")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    plane = gp.GossipPlane(cfg)
    await plane.start()
    res = {"phase": "plane_nemesis", "scenario": cfg.nemesis,
           "n": plane.n_universe, "ndev": plane._ndev}
    clients = [_Client(f"agent-{i}") for i in range(n_clients)]
    try:
        t_serve = time.perf_counter()
        await asyncio.gather(*(c.start(plane.local_addr[1]) for c in clients))
        names = {c.name for c in clients}
        res["join_s"] = await _until(lambda: all(
            c.members_with(EV_JOIN) >= names - {c.name} for c in clients),
            60, "member-join for every other client")
        await _until(lambda: plane._rounds_done >= rounds, 120,
                     f"{rounds} rounds of the plane")
        res["rounds"] = plane._rounds_done
        res["rounds_per_s"] = plane._rounds_done / (time.perf_counter()
                                                    - t_serve)
        slo = await clients[0].query("slo")
        res["slo_scenario"] = slo.get("scenario")
        res["slo_scenarios"] = sorted(slo.get("scenarios", {}))
        res["kernel"] = (await clients[0].query("stats"))["kernel"]
        disp = (await clients[0].query("device"))["dispatch"]["round_step"]
        res["dispatch"] = {"count": disp["count"], "p50_ms": disp["p50_ms"],
                           "p99_ms": disp["p99_ms"],
                           "mean_ms": disp["sum_ms"] / disp["count"]}
        res["member_failed_seen"] = sorted(
            set().union(*(c.members_with(EV_FAILED) for c in clients)))
    finally:
        for c in clients:
            await c.close()
        await plane.stop()
    _settle()
    res.update(dissem_launches=fused.launches,
               drop_launches=fused.drop_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return res


class _Recorder:
    """A bridge writer that keeps every frame it is sent."""

    def __init__(self):
        self.frames = []

    def write(self, raw):
        self.frames.append(bytes(raw))

    def close(self):
        pass


def _plane_lockstep(n: int = 16_384, dispatches: int = 15) -> dict:
    """The plane on the card and on the CPU under ``partition_heal``, and
    a card plane whose calls replay a round at a time, same config and
    key, driven by one script without sockets: after every dispatch every
    state field and every frame sent must be identical."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import convert
    from consul_tpu_torch.gossip import plane as gp

    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    journey, gp._journey.journey = gp._journey.journey, None
    # The card's plane (looped calls), the CPU's (eager), and a card plane
    # whose calls replay a round at a time (the loop's plain version).
    planes = [gp.GossipPlane(gp.PlaneConfig(
        bind_port=0, capacity=32, sim_nodes=n - 32, slots=64, event_slots=8,
        gossip_interval_s=0.02, probe_every=5, suspicion_mult=1.0,
        hb_lapse_s=0.3, shard_devices=1, dissem="fused", hot_slots=0,
        fused_nb=1, unroll=1, flight_drain_every=2, nemesis="partition_heal",
        device=dev)) for dev in ("cuda", "cpu", "cuda")]
    bad = []
    try:
        for plane in planes:
            loop.run_until_complete(plane.start())
            plane._tick_task.cancel()  # the script dispatches
            plane._key = prng.key(20260)
        writers = []
        for i in range(6):
            msg = {"t": "register", "name": f"n{i}", "addr": "127.0.0.1",
                   "port": 7000 + i, "tags": {"role": "node"}}
            ws = (_Recorder(), _Recorder(), _Recorder())
            writers.append(ws)
            for plane, w in zip(planes, ws):
                plane._register(dict(msg), w)
        for d in range(dispatches):
            planes[0]._dispatch()
            planes[1]._dispatch()
            with _per_round_replays():
                planes[2]._dispatch()
            g = planes[0]
            for other, c in (("cpu", planes[1]), ("replays", planes[2])):
                for a, b in ((g._state, c._state),
                             (g._ev_state, c._ev_state),
                             (g._flight, c._flight), (g._hist, c._hist)):
                    x = convert.state_to_numpy(a)
                    y = convert.state_to_numpy(b)
                    bad += [f"dispatch {d} vs {other}: "
                            f"{type(a).__name__}.{f}" for f in x
                            if not np.array_equal(x[f], y[f])]
            bad += [f"dispatch {d}: frames" for ws in writers
                    if not ws[0].frames == ws[1].frames == ws[2].frames]
        frames = sum(len(ws[0].frames) for ws in writers)
        slo = [p._slo_wire() for p in planes]
        if not slo[0] == slo[1] == slo[2]:
            bad.append("slo frame")
    finally:
        for plane in planes:
            loop.run_until_complete(plane.stop())
        loop.close()
        gp._journey.journey = journey
    return {"n": n, "dispatches": dispatches, "rounds": 4 * dispatches,
            "frames_compared": frames, "diverged": bad,
            "seconds": time.perf_counter() - t0}


def plane_nemesis_phase() -> dict:
    """The plane under ``partition_heal`` on the card (its ticker's
    errors captured from stderr), then the card plane in lockstep with
    the CPU plane.  A full bisection may rightly declare agents dead, so
    member-failed is reported, not gated."""
    from consul_tpu_torch.gossip import fused

    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            res = asyncio.run(_plane_nemesis_run())
    finally:
        sys.stderr.write(err.getvalue())
    res["tick_errors"] = err.getvalue().count("[gossip-plane] tick error")
    _settle()
    drops0 = fused.drop_launches
    res["lockstep"] = _plane_lockstep()
    _settle()
    res["lockstep"]["drop_launches"] = fused.drop_launches - drops0
    emit(res)
    if (res["tick_errors"] or res["drop_launches"] <= 0
            or res["slo_scenario"] != "partition_heal"
            or res["lockstep"]["diverged"]
            or res["lockstep"]["drop_launches"] <= 0):
        raise AssertionError(
            f"plane_nemesis: tick errors {res['tick_errors']}, launches "
            f"with a drop operand {res['drop_launches']}, slo scenario "
            f"{res['slo_scenario']}, lockstep {res['lockstep']}")
    return res


# -- the daemon ------------------------------------------------------------------

def _frame(sock: socket.socket) -> dict:
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("gossipd closed the connection")
            buf += chunk
        return buf
    (ln,) = struct.unpack(">I", exact(4))
    return msgpack.unpackb(exact(ln), raw=False)


def gossipd_phase(timeout: float = 120.0) -> dict:
    """``python -m consul_tpu_torch.gossipd -nemesis partition_heal`` on
    the card: register, welcome, stats, SIGTERM, exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "consul_tpu_torch.gossipd", "-port", "0",
         "-capacity", "64", "-sim-nodes", "960", "-gossip-interval", "0.05",
         "-nemesis", "partition_heal"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        ready, _, _ = select.select([proc.stdout], [], [], timeout)
        line = proc.stdout.readline() if ready else ""
        if "==> gossip plane running at" not in line:
            raise AssertionError(f"gossipd did not come up: {line!r}")
        start_s = time.perf_counter() - t0
        host, port = line.split(" at ")[1].split()[0].rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=30) as sock:
            def send(msg):
                raw = msgpack.packb(msg, use_bin_type=True)
                sock.sendall(struct.pack(">I", len(raw)) + raw)
            send({"t": "register", "name": "probe", "addr": "127.0.0.1",
                  "port": 0, "tags": {}})
            welcome = _frame(sock)
            send({"t": "stats"})
            stats = _frame(sock)
            while stats["t"] != "stats":
                stats = _frame(sock)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    res = {"phase": "gossipd", "line": line.strip(), "start_s": start_s,
           "welcome_id": welcome.get("id"), "stats_capacity":
           stats.get("capacity"), "rc": rc}
    emit(res)
    if (welcome.get("t") != "welcome" or rc != 0
            or "nemesis=partition_heal" not in line):
        raise AssertionError(f"gossipd: rc {rc}, welcome {welcome}, "
                             f"stderr {err[-2000:]}")
    return res


# -- the device-resident state store ------------------------------------------

# The table of a server's store at the device_store_capacity default
# (consul_tpu/agent/config.py), the bridge's probe window, and the op
# batches held against the plain version: the bridge's max_batch, a small
# commit, one entry.
STORE = dict(capacity=65_536, probe=16, seed=31)
STORE_BATCHES = ((4096, 20), (64, 20), (1, 20))
# A server holding about 500,000 keys.
STORE_1M = dict(capacity=1 << 20, keys=500_000, mixed=20, seed=37)
# The matcher: tools/watchstorm.py's largest sweep tier and the reference
# docstring's million watchers, 256 events a batch, lmax 64.
WATCH_W = (65_536, 1 << 20)
WATCH = dict(events=256, lmax=64, seed=41)
WATCH_BATCHES = {65_536: 2, 1 << 20: 1}
# The bridge: the watchstorm watch set, 50 committed batches.
BRIDGE = dict(watches=65_536, batches=50, draws=64, seed=43)
# Chunks of the watch set per oracle task (CPU workers).
ORACLE_CHUNK = 131_072
BRIDGE_CHUNK = 8_192
# The crossval's key prefixes (consul_tpu_torch/state/device_store.py).
_STORE_PREFIXES = ("web/", "web/a/", "db/", "db/shard/", "cfg/", "")


class _Entry:
    """A row of the stand-in store."""

    __slots__ = ("key", "value", "flags", "create_index", "modify_index")

    def __init__(self, key, value, flags, create_index, modify_index):
        self.key, self.value, self.flags = key, value, flags
        self.create_index, self.modify_index = create_index, modify_index


class _Capture:
    """ApplyCapture-shaped record of one batch (consul_tpu/state/store.py):
    ``kv_ops`` ("set", key, index, old_index, existed, flags, value) |
    ("del", key, index, old_index); ``notifies`` ("kv", path, prefix,
    index) | ("table", table, index)."""

    __slots__ = ("kv_ops", "notifies", "consumed")

    def __init__(self):
        self.kv_ops, self.notifies, self.consumed = [], [], False


class _Rows(dict):
    """The stand-in's rows, with the host store's ``items(prefix)``."""

    def items(self, prefix=""):
        return sorted((k, e) for k, e in dict.items(self)
                      if k.startswith(prefix))


class _StoreStandIn:
    """A dict KV store with the host store's semantics for set, CAS,
    delete and delete-tree (consul_tpu/state/store.py ``_kvs_set``,
    ``_kvs_delete``), the port's KVWatchSet and a NotifyGroup per table;
    every mutation is recorded in the current ``_Capture``.  Keys are
    indexed by directory (up to their last "/"), the directories kept
    sorted, so a tree delete finds its victims without a scan."""

    def __init__(self):
        from consul_tpu_torch.state.notify import KVWatchSet, NotifyGroup
        self._kv = _Rows()
        self._dirs: dict = {}
        self._dir_order: list = []
        self._kv_watch = KVWatchSet()
        self._watch = collections.defaultdict(NotifyGroup)
        self.cap = _Capture()

    def begin(self) -> _Capture:
        self.cap = _Capture()
        return self.cap

    def set(self, index, key, value, flags) -> None:
        old = self._kv.get(key)
        self._kv[key] = _Entry(key, value, flags,
                               index if old is None else old.create_index,
                               index)
        d = key[:key.rfind("/") + 1]
        if d not in self._dirs:
            self._dirs[d] = set()
            bisect.insort(self._dir_order, d)
        self._dirs[d].add(key)
        self.cap.kv_ops.append(("set", key, index,
                                0 if old is None else old.modify_index,
                                old is not None, flags, value))
        self.cap.notifies.append(("kv", key, False, index))

    def cas(self, index, key, value, flags, modify_index) -> bool:
        old = self._kv.get(key)
        if modify_index == 0 and old is not None:
            return False
        if modify_index > 0 and (old is None
                                 or old.modify_index != modify_index):
            return False
        self.set(index, key, value, flags)
        return True

    def _delete(self, index, keys, path, prefix) -> None:
        deleted = 0
        for key in keys:
            ent = self._kv.pop(key, None)
            if ent is None:
                continue
            deleted += 1
            self._dirs[key[:key.rfind("/") + 1]].discard(key)
            self.cap.kv_ops.append(("del", key, index, ent.modify_index))
        if deleted:
            self.cap.notifies.append(("kv", path, prefix, index))

    def delete(self, index, key) -> None:
        self._delete(index, [key], key, False)

    def delete_tree(self, index, prefix) -> None:
        # Directories under the prefix hold only victims; a directory that
        # is itself a prefix of it holds some.
        victims = set()
        at = bisect.bisect_left(self._dir_order, prefix)
        while at < len(self._dir_order) and \
                self._dir_order[at].startswith(prefix):
            victims |= self._dirs[self._dir_order[at]]
            at += 1
        for cut in range(len(prefix)):
            if prefix[cut] == "/" and prefix[:cut + 1] != prefix:
                victims |= {k for k in self._dirs.get(prefix[:cut + 1], ())
                            if k.startswith(prefix)}
        self._delete(index, sorted(victims), prefix, True)

    def table(self, index, name) -> None:
        self.cap.notifies.append(("table", name, index))

    def watch_kv(self, prefix, waiter) -> None:
        self._kv_watch.watch(prefix, waiter)


def _store_key(rng) -> str:
    """A key shaped like the crossval's (device_store._random_key): one of
    its prefixes, a 3-hex-digit directory and a leaf, 5% past lmax."""
    p = _STORE_PREFIXES[int(rng.integers(len(_STORE_PREFIXES)))]
    leaf = f"{int(rng.integers(1 << 20)):05x}"
    if rng.random() < 0.05:
        leaf += "x" * 80
    return f"{p}{leaf[:3]}/{leaf[3:]}"


def _store_draw(rng, store: _StoreStandIn, index: int, pool: list,
                key_fn=_store_key, tree_fn=None, tree: bool = True) -> None:
    """One raft entry on the stand-in, the crossval's mix: set 0.55, CAS
    0.15, delete 0.15, delete-tree 0.15 (of the key's directory, or
    ``tree_fn(rng)``; a plain delete where ``tree`` is false).  Keys: 30%
    from the last 64 drawn (repeats inside a batch), 30% any drawn before
    (deletes miss, tombstones are re-set), 40% fresh."""
    u = rng.random()
    if pool and u < 0.3:
        key = pool[-1 - int(rng.integers(min(64, len(pool))))]
    elif pool and u < 0.6:
        key = pool[int(rng.integers(len(pool)))]
    else:
        key = key_fn(rng)
        pool.append(key)
    r = rng.random()
    if r < 0.55:
        store.set(index, key, rng.bytes(8), int(rng.integers(1 << 16)))
    elif r < 0.7:
        ent = store._kv.get(key)
        store.cas(index, key, b"cas", 0,
                  int(rng.choice([0, index - 1 if ent is None
                                  else ent.modify_index])))
    elif r < 0.85 or not tree:
        store.delete(index, key)
    else:
        store.delete_tree(index, tree_fn(rng) if tree_fn
                          else key[:key.rfind("/") + 1])


def _store_stream(seed: int, fill: int, start: int, sizes) -> tuple:
    """Chunks of kv ops for the table: ``fill`` sets of fresh keys in
    chunks of 4,096, then the mixed stream cut into ``sizes`` ((size,
    count), ...) chunks; raft indexes from ``start``.  Returns the chunks
    and the stand-in store after them (the host's state)."""
    rng = np.random.default_rng(seed)
    store, pool, index = _StoreStandIn(), [], start
    ops = store.cap.kv_ops
    while len(ops) < fill:
        key = _store_key(rng)
        if key in store._kv:
            continue
        index += 1
        pool.append(key)
        store.set(index, key, rng.bytes(8), int(rng.integers(1 << 16)))
    chunks = [ops[i:i + 4096] for i in range(0, fill, 4096)]
    need = sum(size * count for size, count in sizes)
    store.begin()
    while len(store.cap.kv_ops) < need:
        index += 1
        # Near the end single-key entries only, so the stream ends exactly
        # at ``need`` and the store is the host's state after it.
        _store_draw(rng, store, index, pool,
                    tree=need - len(store.cap.kv_ops) >= 256)
    if len(store.cap.kv_ops) != need:
        raise AssertionError(f"the store stream overshot: "
                             f"{len(store.cap.kv_ops)} ops for {need}")
    mixed, at = store.cap.kv_ops, 0
    for size, count in sizes:
        for _ in range(count):
            chunks.append(mixed[at:at + size])
            at += size
    return chunks, store


def _one_key_ops(n: int, start: int) -> list:
    """``n`` kv ops of one key on the stand-in: sets, and deletes where it
    is live (a quarter of the draws), raft indexes from ``start``."""
    rng = np.random.default_rng(STORE["seed"] + 2)
    store, index = _StoreStandIn(), start
    while len(store.cap.kv_ops) < n:
        index += 1
        if rng.random() < 0.25:
            store.delete(index, "web/one/key")
        else:
            store.set(index, "web/one/key", rng.bytes(8), 1)
    return store.cap.kv_ops


def _store_encoder():
    from consul_tpu_torch.state import device_store as tds
    return tds.DeviceStoreBridge(capacity=64, stats=None, device="cpu")


def _table_digest(tab) -> str:
    import hashlib
    return hashlib.sha256(tab[0].cpu().numpy().tobytes()
                          + tab[1].cpu().numpy().tobytes()).hexdigest()


def _store_apply_cpu(capacity: int, probe: int, seed: int) -> tuple:
    """apply_ref over the whole stream of store_apply (a), in a worker:
    per chunk the verdicts and the table's digest; the final table."""
    torch.set_num_threads(1)
    from consul_tpu_torch.state import device_store as tds
    enc = _store_encoder()
    tab = (torch.zeros((capacity, tds.SLOT_COLS), dtype=torch.int32),
           torch.zeros((), dtype=torch.int32))
    out = []
    chunks, _ = _store_stream(seed, capacity // 2, 2**31 - 50_000,
                              STORE_BATCHES)
    for chunk in chunks:
        ops, _ = enc._encode_ops(chunk)
        tab, (existed, old) = tds.apply_ref(tab, ops, probe)
        out.append((existed.numpy(), old.numpy(), _table_digest(tab)))
    return out, tab[0].numpy(), int(tab[1])


def _store_bound(ops: torch.Tensor, before: torch.Tensor,
                 after: torch.Tensor, probe: int) -> dict:
    """The least time for one kv_apply batch: the bytes it must move over
    the memory rate.  Read once: the op fields (opc, h1, h2, index,
    digest, flags: 24 bytes an op), the state and both fingerprints of
    every slot in the batch's windows (12 bytes a slot), and the modify
    index of each key the batch finds live in the table it starts from
    (a later op on that key reads what an earlier one wrote); written
    once: the verdicts (5 bytes an op) and every 32-bit word of the table
    that the batch changes.  The operations (a few dozen integer
    operations an op) are far below: the batch is one dependent chain
    (csrc/kv_store.cu)."""
    from consul_tpu_torch.state import device_store as tds
    B = ops.shape[0]
    C = before.shape[0]
    o = ops.cpu().to(torch.int64) & 0xFFFFFFFF
    t = before.cpu().to(torch.int64) & 0xFFFFFFFF
    slots = (o[:, 1:2] + torch.arange(probe)) & (C - 1)
    windows = slots.unique().numel()
    # The first slot of each op's window that holds its key (live or
    # tombstone), as the kernel's ballot finds it, in the starting table.
    rows = t[slots]
    hit = ((rows[..., 0] != tds.SLOT_EMPTY)
           & (rows[..., 1] == o[:, 1:2]) & (rows[..., 2] == o[:, 2:3]))
    first = hit.to(torch.int8).argmax(dim=1)
    slot = slots.gather(1, first[:, None])[:, 0]
    live = hit.any(dim=1) & (t[slot, 0] == tds.SLOT_LIVE) & (o[:, 0] >= 0)
    modify_reads = slot[live].unique().numel()
    written_words = int((before != after).sum())
    nbytes = (24 * B + 12 * windows + 4 * modify_reads + 5 * B
              + 4 * written_words)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "window_slots": windows,
            "modify_reads": modify_reads, "written_words": written_words,
            "bytes_ms": bytes_ms, "bound_ms": bytes_ms, "bound_by": "bytes"}


# Operations per (watch, event) pair of the matcher, by the event's kind.
# The kind is one value per event, the same across a warp, so it selects
# one branch and costs no per-lane operation; the watch's own flags (live,
# key-or-prefix, table) are hoisted out of the event loop.  A compare takes
# a predicate and ANDs it in (ISETP's chaining operand), so a branch is a
# chain of compares and one OR into the watch's fired flag.  A KV event:
# the length compare, the two prefix-hash compares and the unsigned index
# compare, then the OR: 5.  A TABLE event: the two table-hash compares and
# the index compare, then the OR: 4.  A pad event: none.  The prefix
# hashes' loads run on the load/store units and count as bytes only.
MATCH_OPS_KV_EVENT = 5
MATCH_OPS_TABLE_EVENT = 4


def _match_bound(W: int, events: torch.Tensor, lmax: int) -> dict:
    """The least time for one watch_match launch over the [5, B] event
    rows ``events``: the larger of its bytes over the memory rate (the
    [5, W] watch rows read and the fired bytes and packed words written,
    the event rows and [2, B, lmax + 1] prefix hashes read) and its pair
    operations (per watch, those of each event's branch) over the 32-bit
    integer rate."""
    from consul_tpu_torch.state import device_store as tds
    B = events.shape[1]
    kind = events[0].cpu()
    n_kv = int((kind == tds.EV_KV).sum())
    n_table = int((kind == tds.EV_TABLE).sum())
    nbytes = 20 * W + W + W // 8 + 20 * B + 8 * B * (lmax + 1)
    nops = W * (MATCH_OPS_KV_EVENT * n_kv + MATCH_OPS_TABLE_EVENT * n_table)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "kv_events": n_kv, "table_events": n_table,
            "operations": nops, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _same(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Max abs difference of two int tensors; raise unless 0."""
    err = int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64))
              .abs().max()) if got.numel() else 0
    if err or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel != plain (max abs err {err})")
    return err


def store_apply_phase(cpu, card_line: str) -> dict:
    """(a) kv_apply against apply_ref: the capacity-65,536 stream (filled
    to half, then 20 batches each of 4,096, 64 and 1 op of the crossval's
    mix, indexes across 2**31), every chunk's verdicts and the whole table
    equal to the CPU worker's apply_ref run; the capacity-64 stream that
    exhausts its windows and re-sets tombstoned keys, against apply_ref in
    this process; timings on copies of the table."""
    from consul_tpu_torch.state import device_store as tds
    t0 = time.perf_counter()
    C, P = STORE["capacity"], STORE["probe"]
    enc = _store_encoder()
    chunks, _ = _store_stream(STORE["seed"], C // 2, 2**31 - 50_000,
                              STORE_BATCHES)
    table = tds.DeviceKVTable(C, P, device="cuda")
    tab = table.tab
    cards, host_diverged = [], 0
    for chunk in chunks:
        ops, _ = enc._encode_ops(chunk)
        existed, old = tds.kv_apply(tab, ops.cuda(), P)
        e, o = existed.cpu().numpy(), old.cpu().numpy()
        cards.append((e, o, _table_digest(tab), ops))
        for i, op in enumerate(chunk):
            h_existed = op[4] if op[0] == "set" else True
            h_old = (op[3] & 0xFFFFFFFF) if h_existed else 0
            host_diverged += (bool(e[i]) != bool(h_existed)
                              or int(o.view(np.uint32)[i]) != h_old)
    wait0 = time.perf_counter()
    ref, ref_slots, ref_full = cpu.result()
    wait_s = time.perf_counter() - wait0
    for k, ((e, o, dig, _), (re, ro, rdig)) in enumerate(zip(cards, ref)):
        if not (np.array_equal(e, re) and np.array_equal(o, ro)):
            raise AssertionError(f"kv_apply verdicts != apply_ref's in "
                                 f"chunk {k}")
        if dig != rdig:
            raise AssertionError(f"kv_apply table != apply_ref's after "
                                 f"chunk {k}")
    err = max(_same("kv_apply slots", tab[0], torch.from_numpy(ref_slots)),
              abs(int(tab[1]) - ref_full))
    live, tomb, full = table.occupancy()

    # The capacity-64 stream: more keys than slots, deletes and re-sets.
    small = (torch.zeros((64, tds.SLOT_COLS), dtype=torch.int32),
             torch.zeros((), dtype=torch.int32))
    small_card = tuple(t.cuda() for t in small)
    rng = np.random.default_rng(STORE["seed"] + 1)
    keys = [_store_key(rng) for _ in range(100)]
    store, resets, index, deleted = _StoreStandIn(), 0, 7, set()
    for _ in range(12):
        store.begin()
        while len(store.cap.kv_ops) < 16:
            index += 1
            key = keys[int(rng.integers(len(keys)))]
            if rng.random() < 0.3:
                if key in store._kv:
                    deleted.add(key)
                store.delete(index, key)
            else:
                resets += key in deleted and key not in store._kv
                store.set(index, key, rng.bytes(4), 1)
        ops, _ = enc._encode_ops(store.cap.kv_ops)
        small, (re, ro) = tds.apply_ref(small, ops, P)
        existed, old = tds.kv_apply(small_card, ops.cuda(), P)
        err = max(err, _same("kv_apply verdicts (64)", existed, re),
                  _same("kv_apply old index (64)", old, ro),
                  _same("kv_apply slots (64)", small_card[0], small[0]),
                  _same("kv_apply full (64)", small_card[1], small[1]))
    small_full = int(small[1])
    if small_full == 0 or resets == 0:
        raise AssertionError(f"the capacity-64 stream exhausted {small_full} "
                             f"windows and re-set {resets} deleted keys")

    # Times: each size on a copy of the final table, the ops of its last
    # chunk; the plain version on the card at the same shapes.  How each
    # batch ran (its levels, the ops walked in order, each phase's clock
    # cycles) from its first launch.
    times = {}
    last = {len(c): cards[k][3] for k, c in enumerate(chunks)}
    for B, _ in STORE_BATCHES:
        ops = last[B].cuda()
        copy = tuple(t.clone() for t in tab)
        before = copy[0].clone()
        _, sched = tds.kv_apply_schedule(copy, ops, P)
        bound = _store_bound(ops, before, copy[0], P)
        ms = graph_ms(lambda: tds.kv_apply(copy, ops, P))
        plain_ms = cuda_ms(lambda: tds.apply_ref(copy, ops, P),
                           1 if B > 64 else 3, warm=1)
        times[B] = {"ms": ms, "ns_per_op": ms * 1e6 / B,
                    "plain_ms": plain_ms, **sched, **bound,
                    "share_of_bound": bound["bound_ms"] / ms}
    # Two chains the schedule must survive, on the final table, held
    # against apply_ref and timed: 4,096 ops on one key (one chain, walked
    # in order) and the first 2,049 ops of the last 4,096 chunk padded as
    # the bridge pads it (2,047 pad rows at the end, which must not chain).
    edge = {"one_key": _one_key_ops(4096, 2**31 - 10),
            "trailing_pads": [c for c in chunks if len(c) == 4096][-1][:2049]}
    for name, kv_ops in edge.items():
        ops = enc._encode_ops(kv_ops)[0].cuda()
        copy = tuple(t.clone() for t in tab)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want, (re, ro) = tds.apply_ref(tab, ops, P)
        end.record()
        end.synchronize()
        (e, o), sched = tds.kv_apply_schedule(copy, ops, P)
        err = max(err, _same(f"kv_apply existed ({name})", e, re),
                  _same(f"kv_apply old index ({name})", o, ro),
                  _same(f"kv_apply slots ({name})", copy[0], want[0]),
                  _same(f"kv_apply full ({name})", copy[1], want[1]))
        bound = _store_bound(ops, tab[0], want[0], P)
        ms = graph_ms(lambda: tds.kv_apply(copy, ops, P))
        times[name] = {"ms": ms, "ns_per_op": ms * 1e6 / ops.shape[0],
                       "plain_ms": start.elapsed_time(end), **sched,
                       **bound, "share_of_bound": bound["bound_ms"] / ms}
    if (times["one_key"]["walked_ops"] != 4096
            or times["trailing_pads"]["walked_ops"]):
        raise AssertionError(f"kv_apply scheduled the one-key batch "
                             f"{times['one_key']} and the padded chunk "
                             f"{times['trailing_pads']}")
    res = {"phase": "store_apply", "card": card_line, "capacity": C,
           "probe": P,
           "chunks": len(chunks), "ops": sum(len(c) for c in chunks),
           "tolerance": 0, "max_abs_err": err, "live": live,
           "tombstones": tomb, "full": full,
           "verdicts_unlike_host_prestate": host_diverged,
           "small_stream": {"capacity": 64, "full": small_full,
                            "resets_of_deleted_keys": resets},
           "times": {str(k): v for k, v in times.items()},
           "cpu_wait_s": wait_s, "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def store_1m_phase() -> dict:
    """(a) at capacity 1,048,576, card only: 500,000 keys set in chunks of
    4,096, then 20 mixed chunks of 4,096, indexes wrapping past 2**32.
    Every verdict is held against a dict model of the host's pre-state
    (existed, old modify index mod 2**32).  Where a probe window is
    exhausted the table drops the set and counts it in ``full`` (the
    reference's design: the host store stays authoritative); a verdict
    may then differ from the host's only by missing a key the card does
    not hold, and the script checks exactly that: the keys the card
    misses are found by looking each host-live key up in the card's
    table, their number never exceeds ``full``, and every other verdict
    equals the host's."""
    from consul_tpu_torch.state import device_store as tds
    t0 = time.perf_counter()
    C, P = STORE_1M["capacity"], STORE["probe"]
    chunks, host = _store_stream(STORE_1M["seed"], STORE_1M["keys"],
                                 2**32 - 300_000, ((4096, STORE_1M["mixed"]),))
    enc = _store_encoder()
    table = tds.DeviceKVTable(C, P, device="cuda")
    lanes = torch.arange(P, device="cuda")
    dropped: set = set()
    unexplained = explained = 0
    for chunk in chunks:
        ops, _ = enc._encode_ops(chunk)
        ops = ops.cuda()
        existed, old = tds.kv_apply(table.tab, ops, P)
        e = existed.cpu().numpy()
        o = old.cpu().numpy().view(np.uint32)
        # Which keys of this chunk does the card hold live after it?
        h1 = ops[:, 1].to(torch.int64) & 0xFFFFFFFF
        rows = table.tab[0][(h1[:, None] + lanes) & (C - 1)]
        held = ((rows[..., 0] == tds.SLOT_LIVE)
                & (rows[..., 1] == ops[:, 1:2])
                & (rows[..., 2] == ops[:, 2:3])).any(dim=1).cpu().numpy()
        held = {op[1]: bool(held[i]) for i, op in enumerate(chunk)}
        first_set: dict = {}
        for i, op in enumerate(chunk):
            if op[0] == "set":
                first_set.setdefault(op[1], i)
        for i, op in enumerate(chunk):
            key = op[1]
            h_existed = op[4] if op[0] == "set" else True
            h_old = (op[3] & 0xFFFFFFFF) if h_existed else 0
            if bool(e[i]) == bool(h_existed) and int(o[i]) == h_old:
                continue
            # The card misses a key the host holds: one it dropped before
            # this chunk, or one whose set earlier in this chunk found a
            # full window (the card does not hold it after the chunk).
            missing = key in dropped or (not held[key]
                                         and first_set.get(key, i) < i)
            if h_existed and not e[i] and o[i] == 0 and missing:
                explained += 1
            else:
                unexplained += 1
        last = {op[1]: op[0] for op in chunk}
        for key, kind in last.items():
            if kind == "set" and not held[key]:
                dropped.add(key)
            else:
                dropped.discard(key)
    live, tomb, full = table.occupancy()
    res = {"phase": "store_1m", "capacity": C, "probe": P,
           "keys_set": STORE_1M["keys"], "chunks": len(chunks),
           "ops": sum(len(c) for c in chunks), "live": live,
           "tombstones": tomb, "full": full, "host_live": len(host._kv),
           "keys_not_held": len(dropped),
           "verdicts_explained_by_drops": explained,
           "verdicts_unexplained": unexplained,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if unexplained:
        raise AssertionError(f"store_1m: {unexplained} verdicts differ from "
                             f"the host's pre-state")
    if len(dropped) > full or live != len(host._kv) - len(dropped):
        raise AssertionError(f"store_1m: the card holds {live} keys, the "
                             f"host {len(host._kv)}, {len(dropped)} dropped "
                             f"with full = {full}")
    return res


def _watch_pred(i: int):
    """Watch ``i`` of the matcher's set, watchstorm's shape
    (tools/watchstorm.py): ``svc/`` (i = 0) and a prefix watch per service
    shard ``svc/<i>/``; every 8th a key watch on one of the shard's keys,
    every 16th a table watch; every 5th gated at a min index just below
    or just above 2**31."""
    from consul_tpu_torch.state.notify import (KIND_KEY, KIND_PREFIX,
                                               KIND_TABLE, WatchPredicate)
    if i == 0:
        return WatchPredicate(KIND_PREFIX, "svc/")
    gate = (0, 2**31 - 100, 2**31 + 100)[(i // 5) % 3] if i % 5 == 0 else 0
    if i % 16 == 3:
        return WatchPredicate(KIND_TABLE, ("nodes", "services")[i // 16 % 2],
                              gate)
    if i % 8 == 5:
        return WatchPredicate(KIND_KEY, f"svc/{i:07d}/key/{i % 64}", gate)
    return WatchPredicate(KIND_PREFIX, f"svc/{i:07d}/", gate)


def _watch_events(W: int, batch: int, events: int, seed: int) -> list:
    """One batch of capture notifies: a correlated burst on 4 hot service
    shards (tools/watchstorm.py ``_bursts``), every 64th a table event,
    every 50th path past lmax; indexes from just below 2**31."""
    rng = np.random.default_rng([seed, W, batch])
    hot = rng.integers(1, W, 4)
    index = 2**31 - events // 2 + batch * events
    out = []
    for k in range(events):
        index += 1
        if k % 64 == 63:
            out.append(("table", ("nodes", "services")[k // 64 % 2], index))
            continue
        path = f"svc/{int(hot[k % 4]):07d}/key/{int(rng.integers(64))}"
        if k % 50 == 7:
            path += "/" + "x" * 70
        out.append(("kv", path, False, index))
    return out


def _mutations(notifies) -> list:
    from consul_tpu_torch.state.notify import StoreMutation
    return [StoreMutation(ev[1], ev[3], prefix=ev[2]) if ev[0] == "kv"
            else StoreMutation(ev[1], ev[2], kv=False) for ev in notifies]


def _watch_oracle(W: int, lo: int, hi: int, events: int, seed: int) -> list:
    """match_batch (the notify copy's) over watches [lo, hi) of the
    matcher's set, for each of its batches, in a worker: fired indices."""
    from consul_tpu_torch.state.notify import match_batch
    preds = [_watch_pred(i) for i in range(lo, hi)]
    return [sorted(lo + i for i in match_batch(
        preds, _mutations(_watch_events(W, b, events, seed))))
        for b in range(WATCH_BATCHES[W])]


def _oracle_chunks(W: int, chunk: int) -> list:
    return [(lo, min(lo + chunk, W)) for lo in range(0, W, chunk)]


def store_match_phase(oracle: dict, card_line: str) -> dict:
    """(b) watch_match against match_ref on the card and the notify copy's
    match_batch (CPU workers) at W = 65,536 and 1,048,576: KEY, PREFIX and
    TABLE watches, min index gates on both sides of 2**31, 256 events a
    batch.  ``oracle``: W -> the futures of its chunks."""
    from consul_tpu_torch.state import device_store as tds
    t0 = time.perf_counter()
    enc = tds.DeviceStoreBridge(capacity=64, stats=None, device="cuda",
                                lmax=WATCH["lmax"])
    rows, err = {}, 0
    for W in WATCH_W:
        watches = enc.encode_predicates([_watch_pred(i) for i in range(W)])
        fired_n = 0
        for b in range(WATCH_BATCHES[W]):
            ev, hp = enc._encode_events(_watch_events(W, b, WATCH["events"],
                                                      WATCH["seed"]))
            fired, packed = tds.watch_match(watches, ev, hp, WATCH["lmax"])
            want_f, want_p = tds.match_ref(watches, ev, hp, WATCH["lmax"])
            err = max(err, _same("watch_match fired", fired, want_f),
                      _same("watch_match packed", packed, want_p))
            got = set(torch.nonzero(fired).flatten().tolist())
            want = {i for fut in oracle[W] for i in fut.result()[b]}
            if got != want:
                raise AssertionError(
                    f"watch_match at W={W} batch {b}: {len(got ^ want)} "
                    f"watches differ from match_batch's")
            fired_n += len(got)
        B = ev.shape[1]
        bound = _match_bound(W, ev, WATCH["lmax"])
        # The pairs the kernel evaluated: every watch against each KV and
        # TABLE event, as _match_bound counts them.
        counts = tds.watch_match_stats(watches, ev, hp, WATCH["lmax"])
        pairs = counts["pairs"]
        bound_pairs = W * (bound["kv_events"] + bound["table_events"])
        if pairs != bound_pairs:
            raise AssertionError(f"watch_match at W={W} evaluated {pairs} "
                                 f"pairs, _match_bound counts "
                                 f"{bound_pairs}")
        ms = graph_ms(lambda: tds.watch_match(watches, ev, hp,
                                              WATCH["lmax"]))
        plain_ms = cuda_ms(lambda: tds.match_ref(watches, ev, hp,
                                                 WATCH["lmax"]), 3, warm=1)
        rows[W] = {"W": W, "B": B, "batches": WATCH_BATCHES[W],
                   "fired": fired_n, "ms": ms, "plain_ms": plain_ms,
                   "pairs_evaluated": pairs, "pairs_in_bound": bound_pairs,
                   "staging_cycles": counts["staging_cycles"],
                   "matching_cycles": counts["matching_cycles"],
                   **bound, "share_of_bound": bound["bound_ms"] / ms}
        del watches
    res = {"phase": "store_match", "card": card_line,
           "lmax": WATCH["lmax"], "tolerance": 0,
           "max_abs_err": err, "rows": list(rows.values()),
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


class _Waiter:
    """A blocking query's wakeup: counts its wakes."""

    __slots__ = ("sets",)

    def __init__(self):
        self.sets = 0

    def set(self):
        self.sets += 1


def _bridge_key(rng, hot) -> str:
    return f"svc/{int(hot[int(rng.integers(len(hot)))]):07d}/key/" \
           f"{int(rng.integers(64))}"


def _bridge_batches(watches: int, batches: int, draws: int, seed: int):
    """The bridge's committed batches on the stand-in, as a generator of
    (store, capture): ``draws`` entries of the crossval's mix a batch on
    the keys of 4 hot service shards, tree deletes of a shard's key
    directory (one in 20 of a shard-number prefix: the host-only reverse
    direction), one table event."""
    rng = np.random.default_rng(seed)
    store, pool, index = _StoreStandIn(), [], 1000
    for b in range(batches):
        hot = rng.integers(1, watches, 4)
        cap = store.begin()
        for _ in range(draws):
            index += 1
            _store_draw(rng, store, index, pool,
                        key_fn=lambda r: _bridge_key(r, hot),
                        tree_fn=lambda r: (
                            f"svc/{int(hot[0]):07d}"[:8]
                            if r.random() < 0.05 else
                            f"svc/{int(hot[int(r.integers(4))]):07d}/key/"))
        index += 1
        store.table(index, "nodes")
        yield store, cap


def _bridge_oracle(lo: int, hi: int, watches: int, batches: int, draws: int,
                   seed: int) -> list:
    """match_batch over watches [lo, hi) of the bridge's set for each of
    its batches (the watch set is the same before every batch: a woken
    watch re-registers), in a worker: the woken indices."""
    from consul_tpu_torch.state.notify import (KIND_PREFIX, WatchPredicate,
                                               match_batch)
    names = _bridge_watch_names(watches)
    preds = [WatchPredicate(KIND_PREFIX, w) for w in names[lo:hi]]
    out = []
    for _, cap in _bridge_batches(watches, batches, draws, seed):
        kv = [m for m in _mutations(cap.notifies) if m.kv]
        out.append(sorted(lo + i for i in match_batch(preds, kv)))
    return out


def _bridge_watch_names(watches: int) -> list:
    """tools/watchstorm.py's watch set: ``svc/`` and ``svc/<i>/``."""
    return ["svc/"] + [f"svc/{i:07d}/" for i in range(watches - 1)]


def store_bridge_phase(oracle: list, card_line: str) -> dict:
    """(c) DeviceStoreBridge(capacity=65,536) on the card over the
    stand-in store: the watchstorm watch set, 50 committed batches;
    divergence 0, every woken watch equal to match_batch's (the CPU
    workers' ``oracle`` futures), occupancy equal to the store's live
    count, and again after rebuild_from_store.  The kernels' launches
    here are the store's main path: counted from 0.  on_batch's wall time
    split into encode, apply, match, host walk and the rest."""
    from consul_tpu_torch.state import device_store as tds
    t0 = time.perf_counter()
    bridge = tds.DeviceStoreBridge(capacity=STORE["capacity"],
                                   device="cuda")
    split = collections.Counter()

    def timed(name, fn, sync=False):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            split[name] += time.perf_counter() - t
            return out
        return run

    bridge._encode_ops = timed("encode_ops", bridge._encode_ops)
    bridge.table.apply = timed("apply", bridge.table.apply)
    bridge._encode_events = timed("encode_events", bridge._encode_events)
    bridge._encode_watches = timed("encode_watches", bridge._encode_watches)
    bridge._match = timed("match", bridge._match, sync=True)
    names = _bridge_watch_names(BRIDGE["watches"])
    waiters = [_Waiter() for _ in names]
    tds.apply_launches = tds.match_launches = 0
    woken = batches = 0
    wall = []
    store = None
    for b, (store, cap) in enumerate(_bridge_batches(**BRIDGE)):
        if b == 0:
            for w, waiter in zip(names, waiters):
                store.watch_kv(w, waiter)
            store._kv_watch.matched = timed("host_walk",
                                            store._kv_watch.matched)
        before = [w.sets for w in waiters]
        t = time.perf_counter()
        bridge.on_batch(cap, store)
        wall.append(time.perf_counter() - t)
        want = {i for fut in oracle for i in fut.result()[b]}
        got = {i for i, w in enumerate(waiters) if w.sets > before[i]}
        if got != want or any(w.sets > before[i] + 1
                              for i, w in enumerate(waiters)):
            raise AssertionError(f"bridge batch {b}: {len(got ^ want)} "
                                 f"woken watches differ from match_batch's")
        for i in got:
            store.watch_kv(names[i], waiters[i])
        woken += len(got)
        batches += 1
    launches = {"kv_apply": tds.apply_launches,
                "watch_match": tds.match_launches}
    occ = bridge.occupancy()
    host_live = len(store._kv)
    bridge.rebuild_from_store(store)
    occ_rebuilt = bridge.occupancy()
    n = len(wall)
    res = {"phase": "store_bridge", "card": card_line,
           "watches": BRIDGE["watches"],
           "batches": batches, "divergence": bridge.divergence,
           "woken": woken, "launches": launches, "occupancy": occ,
           "host_live": host_live, "occupancy_rebuilt": occ_rebuilt,
           "table_load": (occ[0] + occ[1]) / bridge.capacity,
           "on_batch_ms_mean": sum(wall) / n * 1e3,
           "on_batch_ms_max": max(wall) * 1e3,
           "split_ms_per_batch": {k: v / n * 1e3 for k, v in split.items()},
           "rest_ms_per_batch": (sum(wall) - sum(split.values())) / n * 1e3,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if bridge.divergence:
        raise AssertionError(f"bridge divergence {bridge.divergence}")
    if occ[0] != host_live or occ_rebuilt[0] != host_live or occ[2]:
        raise AssertionError(f"bridge occupancy {occ} / rebuilt "
                             f"{occ_rebuilt}, host {host_live}")
    if not all(launches.values()):
        raise AssertionError(f"the bridge's path launched {launches}")
    return res


def feistel_phase() -> dict:
    """(d) gossip_sources (n = 1,000,000, fanout 3), gossip_partners and
    random_targets on the card equal to the CPU's, for two keys."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.ops import feistel as tf
    t0 = time.perf_counter()
    n = 1_000_000
    for seed in (3, 2**31 - 1):
        k = prng.key(seed)
        pairs = [tuple(tf.gossip_sources(k, n, 3, device=d)
                       for d in ("cuda", "cpu"))]
        pairs.append(tuple(torch.stack(tf.gossip_partners(k, n, device=d))
                           for d in ("cuda", "cpu")))
        pairs.append(tuple(tf.random_targets(k, n, (n,), device=d)
                           for d in ("cuda", "cpu")))
        x = torch.arange(n, dtype=torch.int64)
        pairs.append(tuple(tf.feistel_permute(x.to(d), k, n)
                           for d in ("cuda", "cpu")))
        for name, (card, cpu) in zip(("gossip_sources", "gossip_partners",
                                      "random_targets", "feistel_permute"),
                                     pairs):
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"{name} on the card != the CPU's "
                                     f"(seed {seed})")
    res = {"phase": "feistel", "n": n, "fanout": 3, "keys": 2,
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def store_shapes_vs_plain(shapes: set) -> list:
    """Every (kernel, ...) the store's paths launched at (``launch_shapes``
    of consul_tpu_torch/state/device_store.py) held against the plain
    version on the card on fresh inputs: kv_apply on two batches of
    random ops into an empty table, watch_match on random rows whose
    hashes collide often; tolerance 0."""
    from consul_tpu_torch.state import device_store as tds
    rows = []
    for i, shape in enumerate(sorted(shapes)):
        rng = np.random.default_rng(200 + i)
        if shape[0] == "kv_apply":
            _, C, P, B = shape
            ref = (torch.zeros((C, tds.SLOT_COLS), dtype=torch.int32,
                               device="cuda"),
                   torch.zeros((), dtype=torch.int32, device="cuda"))
            tab = tuple(t.clone() for t in ref)
            for b in range(2):
                ops = _random_ops(rng, C, B, max(B, 8), 2**31 - B + b * B)
                ref, (re, ro) = tds.apply_ref(ref, ops, P)
                e, o = tds.kv_apply(tab, ops, P)
                for name, a, w in (("existed", e, re), ("old", o, ro),
                                   ("slots", tab[0], ref[0]),
                                   ("full", tab[1], ref[1])):
                    _same(f"kv_apply {name} at {shape}", a, w)
        else:
            _, W, B, lmax = shape
            watches, ev, hp = _random_match_rows(rng, W, B, lmax)
            f, p = tds.watch_match(watches, ev, hp, lmax)
            wf, wp = tds.match_ref(watches, ev, hp, lmax)
            _same(f"watch_match fired at {shape}", f, wf)
            _same(f"watch_match packed at {shape}", p, wp)
        rows.append({"kernel": shape[0], "shape": list(shape[1:])})
    return rows


def _random_ops(rng, C: int, B: int, n_keys: int, start: int):
    """Sets, deletes and pad rows over a clustered key pool (key 0 has
    fingerprints (0, 0), which pad rows match), on the card."""
    from consul_tpu_torch.state import device_store as tds
    span = max(C // 8, 2)
    h1 = ((rng.integers(0, 2**32, n_keys, dtype=np.uint64)
           & np.uint64(2**32 - C))
          | rng.integers(0, span, n_keys).astype(np.uint64)).astype(np.uint32)
    h2 = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    h1[0] = h2[0] = 0
    k = rng.integers(0, n_keys, B)
    opc = rng.choice(np.asarray([tds.OP_SET, tds.OP_SET, tds.OP_DEL,
                                 tds.OP_PAD], np.int32), B)
    pad = opc == tds.OP_PAD
    words = rng.integers(0, 2**32, (2, B), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(tds._pack_ops(
        opc, np.where(pad, 0, h1[k]), np.where(pad, 0, h2[k]),
        ((start + np.arange(B)) % 2**32).astype(np.uint32), words[0],
        words[1])).cuda()


def _random_match_rows(rng, W: int, B: int, lmax: int):
    """Watch and event rows whose hashes collide often (4-word alphabet),
    pads and tables among the kinds, lengths around lmax, indexes and
    min indexes on both sides of 2**31, on the card."""
    from consul_tpu_torch.state import device_store as tds
    abc = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    near = np.asarray([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1],
                      np.uint32)
    watches = tds._pack_rows(
        rng.choice(np.asarray([-1, 0, 1, 2], np.int32), W),
        rng.choice(abc, W), rng.choice(abc, W),
        rng.integers(-2, lmax + 3, W).astype(np.int32), rng.choice(near, W))
    events = tds._pack_rows(
        rng.choice(np.asarray([-1, 0, 0, 1], np.int32), B),
        rng.integers(-1, lmax + 90, B).astype(np.int32), rng.choice(near, B),
        rng.choice(abc, B), rng.choice(abc, B))
    hp = np.ascontiguousarray(rng.choice(abc, (2, B, lmax + 1)).view(np.int32))
    return tuple(torch.from_numpy(a).cuda() for a in (watches, events, hp))


def _store_kernel_row(name: str, store: dict) -> dict:
    """The kernels line's entry of a store kernel: launches on the store's
    main path (the bridge's batches), the times at the bridge's shapes
    (kv_apply: a batch of 4,096 ops at capacity 65,536; watch_match:
    65,536 watches, 256 events) and, beside them, the smaller batches and
    the million watchers."""
    row = {"name": name, "route": "cuda",
           "source": "consul_tpu_torch/csrc/kv_store.cu",
           "launches": store["bridge"]["launches"][name],
           "library_ms": None}
    if name == "kv_apply":
        (big, small, one) = (store["apply"]["times"][str(B)]
                             for B, _ in STORE_BATCHES)
        return {**row, "replaces": "consul_tpu/state/device_store.py:158",
                "max_abs_err": store["apply"]["max_abs_err"],
                "ms": big["ms"], "plain_ms": big["plain_ms"],
                "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
                "ns_per_op": big["ns_per_op"], "levels": big["levels"],
                "walked_ops": big["walked_ops"], "ms_64": small["ms"],
                "ms_1": one["ms"], "plain_ms_64": small["plain_ms"],
                "plain_ms_1": one["plain_ms"],
                "ms_one_key": store["apply"]["times"]["one_key"]["ms"],
                "ms_trailing_pads":
                    store["apply"]["times"]["trailing_pads"]["ms"]}
    small, big = store["match"]["rows"]
    return {**row, "replaces": "consul_tpu/state/device_store.py:215",
            "max_abs_err": store["match"]["max_abs_err"],
            "ms": small["ms"], "plain_ms": small["plain_ms"],
            "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
            "ms_1m": big["ms"], "plain_ms_1m": big["plain_ms"],
            "bound_ms_1m": big["bound_ms"]}


def store_phases(store_cpu, watch_oracle, bridge_oracle,
                 card_line: str) -> dict:
    """The device_store phase: (a) store_apply and store_1m, (b)
    store_match, (c) store_bridge, (d) feistel; one line with its time.
    Every line with times carries ``card_line`` (nvidia-smi's name and
    power limit)."""
    t0 = time.perf_counter()
    out = {"apply": store_apply_phase(store_cpu, card_line),
           "big": store_1m_phase(),
           "match": store_match_phase(watch_oracle, card_line),
           "bridge": store_bridge_phase(bridge_oracle, card_line),
           "feistel": feistel_phase()}
    emit({"phase": "device_store", "seconds": time.perf_counter() - t0})
    return out


def _round_graph_row(rp: dict, churn: dict) -> dict:
    """The kernels line's entry of the round program
    (``csrc/round_graph.cu``: the joined graphs under the loop, and their
    condition kernels), which replaces the reference's jitted scan:
    graph launches on the churn main path (one a chunk of a call), its
    time a 1M churn round against the eager round's (the plain version)
    and the per-round replays', all from round_program.  Bound: the
    bytes a round must move, the state read once and written once (heard
    [S, N] u8; slot_of_node, incarnation, fail_round and member [N]; the
    ground truth read only)."""
    case = rp["cases"]["churn"]
    S, N = rp["slots"], rp["n"]
    state_bytes = S * N + 4 * N + 4 * N + N
    bound_bytes = 2 * state_bytes + 4 * N
    return {"name": "round_graph", "route": "cuda",
            "source": "consul_tpu_torch/csrc/round_graph.cu",
            "replaces": "consul_tpu/gossip/kernel.py:1689",
            "launches": churn["graph_launches"],
            "max_abs_err": (0 if not any(case["diverged"].values())
                            else None),
            "ms": case["graphed"]["ms_per_round"],
            "plain_ms": case["eager"]["ms_per_round"],
            "replays_ms": case["replays"]["ms_per_round"],
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "device_kernels_per_round":
                case["graphed"]["device_kernels_per_round"]}


def _loop_rows(loop: dict, churn: dict, sharded: dict, rp: dict,
               mdc1: dict, plane1: dict, cross: dict) -> list:
    """The kernels line's entries of the loop (``round_graph.cu``'s
    ``loop_kernel``, which replaces the reference's ``lax.scan`` over a
    call's rounds: one a WHILE iteration of ``program.LOOP_ROUNDS``
    rounds; its toy loop's time a round over a 512-round chunk with 2
    variants, the plain version's ``program.loop_ref`` a round, and the
    profiler's time of the node in the graphed churn round) and of the
    table (``round_table.cu``'s ``table_kernel``, which replaces the
    round's key derivation from the traced round counter: one a chunk of
    a call; its time at 512 rows by CUDA-graph replays, the host build's
    and copy's time, the bound)."""
    lk, tab = loop["kernel"], loop["table"]["timed"][512]
    prof = rp["cases"]["churn"]["graphed"]
    return [{
        "name": "loop_kernel", "route": "cuda",
        "source": "consul_tpu_torch/csrc/round_graph.cu",
        "replaces": "consul_tpu/gossip/kernel.py:1783",
        "launches": churn["loop_launches"],
        "sharded_launches": sharded["loop_launches"],
        "plane_launches": plane1["loop_launches"],
        "crossval_launches": cross["loop_launches"],
        "max_abs_err": lk["max_abs_err"], "ms": lk["ms_per_round"],
        "empty_launch_ms": lk["empty_launch_ms"],
        "round_device_ms": prof["loop_device_ms_per_round"],
        "plain_ms": lk["plain_ms_per_round"], "bound_ms": lk["bound_ms"],
        "bound_by": lk["bound_by"],
        # No one PyTorch call runs a graph's rounds.
        "library_ms": None}, {
        "name": "table_kernel", "route": "cuda",
        "source": "consul_tpu_torch/csrc/round_table.cu",
        "replaces": "consul_tpu/gossip/kernel.py:886",
        "launches": churn["table_launches"],
        "sharded_launches": sharded["table_launches"],
        "plane_launches": plane1["table_launches"],
        "multidc_launches_per_call": mdc1["table_launches_per_call"],
        "max_abs_err": loop["table"]["max_abs_err"], "ms": tab["ms"],
        "eager_ms": tab["eager_ms"], "ms_30_rows": loop["table"]["timed"][
            30]["ms"], "ms_1_row": loop["table"]["timed"][1]["ms"],
        # The parent checkout's kernel in the same call (null without one).
        "parent_ms": tab.get("parent_ms"), "plain_ms": tab["plain_ms"],
        "bound_ms": tab["bound_ms"], "bound_by": tab["bound_by"],
        "round_device_ms_per_call": prof["table_device_ms_per_call"],
        # No one PyTorch call computes threefry keys (torch.rand is
        # Philox, another function).
        "library_ms": None}]


def _choose_row(branch: dict, churn: dict, sharded: dict, rp: dict,
                mdc1: dict, plane1: dict, cross: dict) -> dict:
    """The kernels line's entry of the round program's chooser node
    (``round_graph.cu``'s ``choose_kernel``), which replaces the
    reference's branch choice on the live slots (``n_active`` and the
    conds on it, ``consul_tpu/gossip/kernel.py:1070-1078``): launches on
    the churn main path (one a graphed round), on 8 shards, on the 1M
    multi-DC path (every pool's), on the plane and in crossval; its own
    time (the profiler's, the node alone on the main path's choice, taken
    in round_program) and its graph's with the group's IF nodes, the plain version's, the bytes
    bound, and the device ms a round the profiler saw it take in the
    graphed churn round."""
    alone = branch["choose"]
    return {"name": "choose_kernel", "route": "cuda",
            "source": "consul_tpu_torch/csrc/round_graph.cu",
            "replaces": "consul_tpu/gossip/kernel.py:1070",
            "launches": churn["choose_launches"],
            "sharded_launches": sharded["choose_launches"],
            "multidc_launches": mdc1["choose_launches"],
            "plane_launches": plane1["choose_launches"],
            "crossval_launches": cross["choose_launches"],
            "max_abs_err": alone["max_abs_err"],
            "ms": rp["choose_alone"]["ms"],
            "graph_ms": alone["graph_ms"], "plain_ms": alone["plain_ms"],
            "bound_ms": alone["bound_ms"], "bound_by": alone["bound_by"],
            "round_device_ms": rp["cases"]["churn"]["graphed"][
                "choose_device_ms_per_round"],
            # No one PyTorch call makes a graph's branch choice.
            "library_ms": None}


def _flood_row(flood: dict, mdc1: dict, mdc8: dict, ev: dict,
               plane1: dict) -> dict:
    """The kernels line's entry of the event flood (``csrc/event_flood.cu``),
    which replaces the reference's jitted ``event_round``: launches on the
    1M multi-DC main path (D + 1 a round), on 8 shards per DC, in the
    events phase's card run and on the plane; its time at the multi-DC
    LAN pool's [32, 250,000] (``ms``) and at the plane's [64, 1M], each
    beside its bytes bound and the plain version's time."""
    main = flood["shapes"]["32x250000"]
    big = flood["shapes"]["64x1000000"]
    return {"name": "event_flood", "route": "cuda",
            "source": "consul_tpu_torch/csrc/event_flood.cu",
            "replaces": "consul_tpu/gossip/events.py:100",
            "launches": mdc1["flood_launches"],
            "multidc_launches": mdc1["flood_launches"],
            "sharded_multidc_launches": mdc8["flood_launches"],
            "events_launches": ev["flood_launches_16k_card"],
            "plane_launches": plane1["flood_launches"],
            "max_abs_err": flood["max_abs_err"],
            "ms": main["ms"], "ms_pushpull": main["ms_pushpull"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "share_of_bound": main["share_of_bound"],
            "ms_1m": big["ms"], "plain_ms_1m": big["plain_ms"],
            "bound_ms_1m": big["bound_ms"],
            "share_of_bound_1m": big["share_of_bound"],
            "library_ms": None}


def _observe_row(counts: dict, obs1: dict, obs8: dict, rp: dict,
                 plane1: dict, cross: dict) -> dict:
    """The kernels line's entry of the observers' counts
    (``csrc/observe.cu``), which replace the reference's three XLA
    reductions of the round: launches on the 1M churn main path with the
    observers threaded (one a round and one a non-quiescent round), on 8
    shards, on the plane and in the crossval phase; its time at [64, 1M]
    in the final matrix's form (``ms``: every row) and the spread's
    (``ms_spread``: 25 of 64 rows wanted, ``ms_spread_1`` and
    ``ms_spread_3``: 1 and 3, and ``ms_no_row``: none, the usual round),
    each beside its bound and the plain version's time, and on 8 shards;
    the device ms a round the profiler saw it take on the graphed churn
    round with the observers threaded."""
    main = counts["shapes"]["64x1000000"]
    sharded = counts["shapes"]["64x1000000/8"]
    obs = rp["cases"]["churn"]["graphed_observers"]
    return {"name": "heard_counts", "route": "cuda",
            "source": "consul_tpu_torch/csrc/observe.cu",
            "replaces": "consul_tpu/gossip/kernel.py:1088",
            "replaces_also": ["consul_tpu/gossip/kernel.py:1606",
                              "consul_tpu/gossip/kernel.py:1762"],
            "launches": obs1["observe_launches"],
            "sharded_launches": obs8["observe_launches"],
            "plane_launches": plane1["observe_launches"],
            "crossval_launches": cross["observe_launches"],
            "max_abs_err": counts["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "share_of_bound": main["share_of_bound"],
            **{f"{k}{f}": main[f"{k}{f}"]
               for f in ("_spread", "_spread_1", "_spread_3", "_no_row")
               for k in ("ms", "bound_ms")},
            "plain_ms_spread": main["plain_ms_spread"],
            "ms_8_shards": sharded["ms"],
            "ms_spread_1_8_shards": sharded["ms_spread_1"],
            "device_ms_per_round": obs["observe_device_ms_per_round"],
            "library_ms": None}


def _finish_rows(fin: dict, churn: dict, sharded: dict, plane1: dict,
                 cross: dict, mdc1: dict, rp: dict) -> list:
    """The kernels line's entries of the finish step's passes
    (``csrc/finish.cu``), which replace the reference's XLA fire pass and
    row wipes: launches on the 1M churn main path (the fire once a
    non-quiescent round; the wipe once a round and once a non-quiescent
    round), on 8 shards, on the plane, in crossval and on the 1M multi-DC
    path; their time at [64, 1M] beside the bytes bound of the rows each
    launch reads and writes, the plain version's time and, for the wipe,
    the library call's (``masked_fill_``): the fire with
    every row's timer live (a replay: its rows read, its bytes already
    DEAD), on fresh bytes, with a few rows live and none; the wipe of a
    few rows, of none and of all; the device ms a round the profiler saw
    both take on the graphed churn round."""
    main = fin["shapes"]["64x1000000"]
    prof = rp["cases"]["churn"]["graphed"]
    common = {"route": "cuda", "source": "consul_tpu_torch/csrc/finish.cu",
              "max_abs_err": fin["max_abs_err"],
              "finish_device_ms_per_round":
                  prof["finish_device_ms_per_round"]}
    fire = {"name": "fire_timers", **common,
            "replaces": "consul_tpu/gossip/kernel.py:1548",
            "replaces_also": ["consul_tpu/gossip/kernel.py:1529"],
            "launches": churn["fire_launches"],
            # No one PyTorch call refutes and fires.
            "library_ms": None,
            "sharded_launches": sharded["fire_launches"],
            "plane_launches": plane1["fire_launches"],
            "crossval_launches": cross["fire_launches"],
            "multidc_launches": mdc1["fire_launches"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "share_of_bound": main["share_of_bound"],
            "ms_first": main["ms_first"],
            "bound_first_ms": main["bound_first_ms"],
            "ms_few": main["ms_few"], "bound_few_ms": main["bound_few_ms"],
            "ms_no_row": main["ms_no_row"]}
    wipe = {"name": "wipe_rows", **common,
            "replaces": "consul_tpu/gossip/kernel.py:1629",
            "replaces_also": ["consul_tpu/gossip/kernel.py:734",
                              "consul_tpu/gossip/kernel.py:478"],
            "launches": churn["wipe_launches"],
            "sharded_launches": sharded["wipe_launches"],
            "plane_launches": plane1["wipe_launches"],
            "crossval_launches": cross["wipe_launches"],
            "multidc_launches": mdc1["wipe_launches"],
            "ms": main["wipe_ms"], "rows_wiped": main["wipe_rows"],
            "plain_ms": main["wipe_plain_ms"],
            "library_ms": main["wipe_library_ms"],
            "bound_ms": main["wipe_bound_ms"], "bound_by": "bytes",
            "share_of_bound": main["wipe_share_of_bound"],
            "ms_no_row": main["wipe_ms_no_row"],
            "ms_all": main["wipe_ms_all"],
            "bound_all_ms": main["wipe_bound_all_ms"]}
    return [fire, wipe]


def _probe_rows(probed: dict, churn: dict, sharded: dict, nem1: dict,
                plane1: dict, cross: dict, mdc1: dict, rp: dict) -> list:
    """The kernels line's entries of the probe tick's kernels
    (``csrc/probe.cu``), which replace the reference's XLA probe tick
    (``consul_tpu/gossip/kernel.py:519-822``, its draws included):
    launches on the 1M churn main path (each once a round), on 8 shards,
    under ``partition_heal``, on the plane, in crossval and on the 1M
    multi-DC path (every pool); each kernel's time on the 1M main path's
    data (``_probe_main_inputs``) beside its bound and its plain version's
    time; the device ms a round the profiler saw them take on the graphed
    churn round; and on ``partition_heal``'s window data (its crossed
    probes needy)."""
    main = probed["main"]["1m/1"]
    part = probed["main"]["1m_partition_heal/1"]
    prof = rp["cases"]["churn"]["graphed"]
    rows = []
    for k in PROBE_KERNELS:
        key = f"probe_{k}_launches"
        rows.append({
            "name": f"probe_{k}", "route": "cuda",
            "source": "consul_tpu_torch/csrc/probe.cu",
            "replaces": "consul_tpu/gossip/kernel.py:519",
            "launches": churn[key], "sharded_launches": sharded[key],
            "nemesis_launches": nem1[key], "plane_launches": plane1[key],
            "crossval_launches": cross[key],
            "multidc_launches": mdc1[key],
            "max_abs_err": probed["max_abs_err"],
            "ms": main[f"{k}_ms"], "plain_ms": main[f"{k}_plain_ms"],
            "bound_ms": main[f"{k}_bound_ms"],
            "bound_by": main["lanes_slots_bound_by"] if k == "lanes_slots"
            else "bytes",
            "share_of_bound": main[f"{k}_share_of_bound"],
            "tick_ms": main["ms"], "tick_plain_ms": main["plain_ms"],
            "tick_bound_ms": main["bound_ms"],
            "partition_window_ms": part[f"{k}_ms"],
            "partition_window_bound_ms": part[f"{k}_bound_ms"],
            "partition_window_needy": part["needy"],
            "probe_device_ms_per_round": prof["probe_device_ms_per_round"],
            # No one PyTorch call computes a step of the probe tick.
            "library_ms": None})
    return rows


def _finish_slots_rows(fslots: dict, churn: dict, sharded: dict,
                       obs1: dict, plane1: dict, cross: dict, mdc1: dict,
                       rp: dict) -> list:
    """The kernels line's entries of the finish step's slot kernels
    (``csrc/finish_slots.cu``), which replace the reference's XLA slot
    logic of ``_finish_round`` (``consul_tpu/gossip/kernel.py:1461-1672``
    but for the matrix passes): launches on the 1M churn main path (each
    once a non-quiescent round), on 8 shards, with the observers threaded
    (the hist banks' adds), on the plane, in crossval and on the 1M
    multi-DC path (every pool); each kernel's time on the 1M main path's
    data (``_finish_slots_main_inputs``) beside its bytes bound and its
    plain version's time, and with the hist banks; the device ms a round
    the profiler saw them take on the graphed churn round."""
    main = fslots["main"]["1m/1"]
    hist = fslots["main"]["1m_hist/1"]
    prof = rp["cases"]["churn"]["graphed"]
    rows = []
    for k in FINISH_SLOTS_KERNELS:
        key = f"finish_{k}_launches"
        rows.append({
            "name": f"finish_{k}", "route": "cuda",
            "source": "consul_tpu_torch/csrc/finish_slots.cu",
            "replaces": "consul_tpu/gossip/kernel.py:1461",
            "launches": churn[key], "sharded_launches": sharded[key],
            "observers_launches": obs1[key], "plane_launches": plane1[key],
            "crossval_launches": cross[key], "multidc_launches": mdc1[key],
            "max_abs_err": fslots["max_abs_err"],
            "ms": main[f"{k}_ms"], "plain_ms": main[f"{k}_plain_ms"],
            "bound_ms": main[f"{k}_bound_ms"], "bound_by": "bytes",
            "share_of_bound": main[f"{k}_share_of_bound"],
            "hist_ms": hist[f"{k}_ms"],
            "hist_bound_ms": hist[f"{k}_bound_ms"],
            "step_ms": main["step_ms"], "step_plain_ms": main["step_plain_ms"],
            "finish_slots_device_ms_per_round":
                prof["finish_slots_device_ms_per_round"],
            # No one PyTorch call computes a step of the slot logic.
            "library_ms": None})
    # Decide behind the tail: the pair's time, and whether the round's
    # graph keeps the programmatic edge.
    rows[0]["tail_decide_pair_ms"] = fslots["tail_decide"]["1m/1"]["pair_ms"]
    rows[0]["pdl_edge_kept"] = fslots["pdl"]["1m/1"]["kept"]
    # Record behind the spread's count, the same.
    rows[2]["count_record_pair_ms"] = \
        fslots["count_record"]["1m/1"]["pair_ms"]
    rows[2]["pdl_edge_kept"] = fslots["pdl"]["count_record/1m/1"]["kept"]
    # Settle behind the fire, the same.
    rows[1]["fire_settle_pair_ms"] = fslots["fire_settle"]["1m/1"]["pair_ms"]
    rows[1]["fire_alone_ms"] = fslots["fire_settle"]["1m/1"]["fire_ms"]
    rows[1]["pdl_edge_kept"] = fslots["pdl"]["fire_settle/1m/1"]["kept"]
    return rows


def _churn_gates(res: dict, launches_key: str) -> None:
    if res["n_detected"] <= 0 or res["n_false_dead"] != 0:
        raise AssertionError(
            f"{res['phase']}: n_detected={res['n_detected']} "
            f"n_false_dead={res['n_false_dead']}")
    if res[launches_key] <= 0:
        raise AssertionError(f"{res['phase']} launched no kernel")


# -- slots past one block: the reference's own provisioning ---------------------

# The slot counts around the one-block kernels' 1,024 rows and the
# reference's own provisioning (crossval.loss_sized_slots: 8,192 at n = 1M
# and 5 % loss; run_nemesis_config: next_pow2(n), 16,384 at n = 10,000),
# each on [S, 16,000]; and [8,192, 1M].
WIDE_SHAPES = tuple((S, 16_000) for S in (1024, 1025, 2048, 8192, 16_384)) \
    + ((8192, 1_000_000),)
WIDE_SEEDS = 3  # fresh states held a shape (one at 1M)
# The card's round against the CPU's under partition_heal: rounds 30-53
# (its window opens at round 40), the hot tier off so every round passes
# every slot.
WIDE_PARITY = dict(n=16_000, steps=24, seed=29, first=30)
WIDE_PARITY_S = (2048, 4096)
# Path (b): run_nemesis_config at its own default slots, next_pow2(n),
# against the port's CPU rows that tools/wide_nemesis_rows.py recorded in
# CROSSVAL_WIDE.json (zone_kill's with the oracle): at [4,096, 4,096] a
# CPU round takes seconds, 400 rounds a scenario.
WIDE_NEMX = dict(n=4096, seeds=1)
WIDE_NEMX_NAMES = ("partition_heal", "zone_kill")
# Path (a): run_config at loss_sized_slots' 8,192, kernel side only.
WIDE_1M = dict(n=1_000_000, n_victims=16, seeds=1, loss=0.05)
WIDE_PROFILED = 5  # rounds of path (a)'s configuration under the profiler
WIDE_PLANE = dict(n=16_384, slots=2048, dispatches=6)
# The kernels' names in a profile: each wide instance.
WIDE_KERNELS = ("observe::counts_wide_kernel", "finish::fire_wide_kernel",
                "finish::wipe_wide_kernel",
                "probe::lanes_slots_wide_kernel",
                "probe::rearm_marks_wide_kernel",
                "finish_slots::decide_wide_kernel",
                "finish_slots::settle_wide_kernel",
                "finish_slots::record_wide_kernel")


def _wide_key(S: int, N: int) -> str:
    return f"{S}x{N}"


def _wide_observe(S: int, N: int, seeds: int) -> dict:
    """``heard_counts`` at [S, N] against its plain version in both forms
    (every row; the spread with ``want`` holes), then timed."""
    from consul_tpu_torch.gossip import observe
    b = OBSERVE_BUDGET
    for seed in range(seeds):
        arg, member, verdict, want = _observe_inputs(S, N, 1, 4000 + S + seed)
        for v, w in ((None, None), (verdict, want)):
            _observe_err(observe.heard_counts(arg, member, b, v, w),
                         observe.heard_counts_ref(arg, member, b, v, w))
        del arg, member, verdict, want
    arg, member, verdict, want = _observe_inputs(S, N, 1, 7)
    sc = observe.counts_scratch(S, "cuda")
    read = int((want & (verdict >= 0) & (verdict <= 3)).sum())
    bound = _observe_bound(S, N, S, "final")
    spread = _observe_bound(S, N, read, "spread")
    row = {"ms": graph_ms(lambda: observe.heard_counts(arg, member, b, None,
                                                       None, sc)),
           "ms_spread": graph_ms(lambda: observe.heard_counts(
               arg, member, b, verdict, want, sc)),
           "plain_ms": cuda_ms(lambda: observe.heard_counts_ref(arg, member,
                                                                b), iters=3),
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "bound_ms_spread": spread["bound_ms"], "rows_read_spread": read}
    if int(sc.abs().sum()):
        raise AssertionError(f"heard_counts left its scratch non-zero at "
                             f"{_wide_key(S, N)}")
    return row


def _wide_finish(S: int, N: int, seeds: int) -> tuple:
    """``fire_timers`` and ``wipe_rows`` at [S, N] against their plain
    versions (every row's timer live with the refutation, two rows, every
    row without it; the wipe of a few rows and of all), then timed:
    ``(fire row, wipe row)``."""
    from consul_tpu_torch.gossip import finish, observe
    sc = observe.counts_scratch(S, "cuda")
    for seed in range(seeds):
        heard, rx, ok_all, ok_few, refute, flags = _finish_inputs(
            S, N, 5000 + S + seed)
        off = 3 if seed % 2 else 0
        for ok, ref in ((ok_all, refute), (ok_few, refute), (ok_all, None)):
            _finish_held(heard, 1, rx, ok, ref, sc, off)
        for fl in (flags, torch.ones_like(flags)):
            _wipe_held(heard, 1, fl, off)
        del heard, rx, ok_all, ok_few, refute, flags
    heard, rx, ok_all, _, refute, flags = _finish_inputs(S, N, 7)
    h = _split_rows(heard, 1)
    del heard
    fire = _finish_bound(S, N, S, 0)
    wipe = _finish_bound(S, N, 0, int(flags.sum()) * N, rx=False)
    fire_row = {"ms": graph_ms(lambda: finish.fire_timers(h, rx, ok_all,
                                                          refute, sc)),
                "plain_ms": cuda_ms(lambda: finish.fire_timers_ref(
                    h, rx, ok_all, refute), iters=3),
                "bound_ms": fire["bound_ms"], "bound_by": fire["bound_by"]}
    wipe_row = {"ms": graph_ms(lambda: finish.wipe_rows(h, flags)),
                "plain_ms": cuda_ms(lambda: finish.wipe_rows_ref(h, flags),
                                    iters=3),
                "rows_wiped": int(flags.sum()),
                "bound_ms": wipe["bound_ms"], "bound_by": "bytes"}
    if int(sc.abs().sum()):
        raise AssertionError(f"fire_timers left its scratch non-zero at "
                             f"{_wide_key(S, N)}")
    return fire_row, wipe_row


def _wide_probe(S: int, N: int, seeds: int, per_hash: float) -> dict:
    """The probe tick's two kernels at [S, N] (the LAN profile's prober
    block, loss 0.01, half the slots free) against their plain versions,
    then timed (``_probe_timed``)."""
    spec = (N, S, 5, 3, 0.01, None, False, 1, S // 2)
    p, nem, ndev, lhm, free = _probe_params(spec)
    seen = {"rearmed": 0, "dropped": 0, "served": 0}
    for seed in range(seeds):
        cfg, t = _probe_inputs(p, nem, ndev, lhm, free, 9100 + S + seed)
        did = _probe_held(cfg, t)
        if did["stats"][3] == 0 or did["served"] + did["dropped"] == 0:
            raise AssertionError(f"probe at {_wide_key(S, N)}: the tick "
                                 f"initiated or allocated nothing: {did}")
        for k in seen:
            seen[k] += did[k] > 0
        del t
    cfg, t = _probe_inputs(p, nem, ndev, lhm, free, 7)
    out = _probe_timed(cfg, t, per_hash)
    out["states_with"] = seen
    return out


def _wide_finish_slots(S: int, N: int, seeds: int) -> dict:
    """The finish step's slot kernels at S rows of N columns (LHM and
    the refutation threaded; the hist banks too below 1M columns, where
    the spread count's plain version, int32 over every byte, still fits
    beside the copies) against their plain versions, then timed
    (``_finish_slots_timed``; the whole step below 1M columns)."""
    small = N < 1_000_000
    spec = (N, S, None, 1, small, True, True, "mixed")
    for seed in range(seeds):
        cfg, t, rx = _finish_slots_inputs(spec, 7100 + S + seed)
        _finish_slots_held(cfg, t, rx)
        del t
    cfg, t, rx = _finish_slots_inputs(spec, 7)
    return _finish_slots_timed(cfg, t, rx, step=small)


def _wide_kernels(per_hash: float) -> dict:
    """Each of the four slot-sized kernel sources at ``WIDE_SHAPES``
    against its plain version (tolerance 0), then timed: kernel name ->
    shape -> its time (CUDA-graph replays), its plain version's, its
    bound."""
    out = {k: {} for k in ("heard_counts", "fire_timers", "wipe_rows",
                           "probe_lanes_slots", "probe_rearm_marks",
                           "finish_decide", "finish_settle",
                           "finish_record")}
    for S, N in WIDE_SHAPES:
        key = _wide_key(S, N)
        seeds = 1 if N >= 1_000_000 else WIDE_SEEDS
        torch.cuda.empty_cache()
        out["heard_counts"][key] = _wide_observe(S, N, seeds)
        torch.cuda.empty_cache()
        out["fire_timers"][key], out["wipe_rows"][key] = _wide_finish(
            S, N, seeds)
        torch.cuda.empty_cache()
        pr = _wide_probe(S, N, seeds, per_hash)
        for k in PROBE_KERNELS:
            out[f"probe_{k}"][key] = {
                "ms": pr[f"{k}_ms"], "plain_ms": pr[f"{k}_plain_ms"],
                "bound_ms": pr[f"{k}_bound_ms"],
                "bound_by": pr["lanes_slots_bound_by"]
                if k == "lanes_slots" else "bytes",
                "rearmed": pr["rearmed"], "needy": pr["needy"],
                "states_with": pr["states_with"]}
        del pr
        torch.cuda.empty_cache()
        fs = _wide_finish_slots(S, N, seeds)
        for k in FINISH_SLOTS_KERNELS:
            out[f"finish_{k}"][key] = {
                "ms": fs[f"{k}_ms"], "plain_ms": fs[f"{k}_plain_ms"],
                "bound_ms": fs[f"{k}_bound_ms"], "bound_by": "bytes",
                "did": fs["did"]}
        del fs
        torch.cuda.empty_cache()
        emit({"phase": "wide_slots_shape", "shape": [S, N],
              **{k: v[key] for k, v in out.items()}})
    return out


def _wide_parity(cpu: dict) -> dict:
    """The round under ``partition_heal`` at [S, 16,000] for
    ``WIDE_PARITY_S`` on the card, on one device and on 8 column shards,
    each against the port's CPU run (``cpu``: S -> the future of its
    worker process): every field of the state, the hist banks, NemState
    and the trace bit-identical; the finish and probe launches exactly
    what the rounds make them."""
    rows, bad = {}, []
    n, steps, seed, first = (WIDE_PARITY[k] for k in ("n", "steps", "seed",
                                                      "first"))
    for S in WIDE_PARITY_S:
        _reset_counts()
        card = _as_numpy(*_nem_run("partition_heal", n, S, steps, seed,
                                   "cuda", hot=0, first=first))
        counts = _round_counts()
        _reset_counts()
        card8 = _as_numpy(*_nem_run("partition_heal", n, S, steps, seed,
                                    "cuda", ndev=8, hot=0, first=first))
        counts8 = _round_counts()
        t1 = time.perf_counter()
        want = cpu[S].result()
        end = card[0][0][1]
        live = int((end["slot_node"] >= 0).sum())
        rows[S] = {"steps": steps, "first": first, "live_slots_end": live,
                   "drops": int(end["drops"]),
                   "round_counts": counts, "round_counts_8_shards": counts8,
                   "diverged_cpu": _diverged_np(card, want),
                   "diverged_8_shards_cpu": _diverged_np(card8, want),
                   "cpu_wait_s": time.perf_counter() - t1}
        # Not vacuous: the partition filled more slots than one block
        # held.
        if rows[S]["diverged_cpu"] or rows[S]["diverged_8_shards_cpu"] \
                or _round_bad(counts) or _round_bad(counts8) or live <= 1024:
            bad.append(S)
    return {"n": n, "steps": steps, "first": first, "seed": seed,
            "slots": rows, "bad": bad}


def _wide_1m_profile() -> dict:
    """``WIDE_PROFILED`` rounds of path (a)'s configuration (its
    parameters and failures, a fresh state, the trace threaded as
    run_config threads it) under the profiler, in this process: run in a
    fresh worker process by ``_wide_1m``, since a process's earlier
    profiler sessions leave the later ones blind to the kernels in a loop
    graph's conditional bodies (``_rp_profile_looped``).  The device's
    busy and occupied ms a round, and the launches of each wide kernel
    the profiler saw by name."""
    from torch.profiler import ProfilerActivity, profile

    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import crossval, kernel
    from consul_tpu_torch.profile_round import (device_kernels,
                                                device_timeline,
                                                fresh_loops, self_device_us)
    p, fail_at, _ = crossval.config_inputs(WIDE_1M["n"],
                                           WIDE_1M["n_victims"],
                                           WIDE_1M["loss"])
    fail = np.full(p.n, NEVER, np.int32)
    for v, t in fail_at.items():
        fail[v] = t
    fail_t = torch.from_numpy(fail).to("cuda")
    key = prng.key(0)

    def run(st):
        out = kernel.run_rounds(st, key, fail_t, p, WIDE_PROFILED,
                                trace=True)[0]
        int(out.round)
        return out

    st = run(kernel.init_state(p, device="cuda"))
    fresh_loops()
    st = run(st)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        st = run(st)
        wall = time.perf_counter() - t1
    _settle()
    kernels = device_kernels(prof)
    busy_us = sum(self_device_us(e) for e in kernels)
    span_us = device_timeline(prof)[0]
    return {"device_busy_ms_per_round": busy_us / 1e3 / WIDE_PROFILED,
            "device_span_ms_per_round": span_us / 1e3 / WIDE_PROFILED,
            "profiled_ms_per_round": wall * 1e3 / WIDE_PROFILED,
            "device_span_idle_share": 1 - span_us / 1e6 / wall,
            "wide_kernels_profiled": {
                k: sum(e.count for e in kernels if k in e.key)
                for k in WIDE_KERNELS}}


def _wide_1m() -> dict:
    """Path (a): ``crossval.run_config`` at n = 1M, 16 victims, one seed,
    loss 0.05, kernel side only, at ``loss_sized_slots``' 8,192 slots (a
    [8,192, 1M] belief matrix), the round graphed through the round
    program's loop; gated on the Lifeguard envelope as the reference
    gates its oracle-free rows (completeness 1, no false dead, p99 inside
    the envelope).  Its slot drops are reported, not gated: under 5 %
    loss they are the model's saturation alarm (``loss_sized_slots``),
    and the card's drops equal the CPU's wherever both run (the parity
    above at 2,048 and 4,096 slots overflows).  Then
    ``_wide_1m_profile`` in a fresh worker process: the device's ms a
    round and every wide kernel the round launches seen by name."""
    from consul_tpu_torch.gossip import crossval
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    row = crossval.run_config(WIDE_1M["n"], WIDE_1M["n_victims"],
                              WIDE_1M["seeds"], loss=WIDE_1M["loss"],
                              oracle=False, device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _round_counts()
    launches = _wide_launches()
    p, _, steps = crossval.config_inputs(WIDE_1M["n"], WIDE_1M["n_victims"],
                                         WIDE_1M["loss"])
    rounds = steps * WIDE_1M["seeds"]
    _close_round_programs()
    with ProcessPoolExecutor(1, mp_context=multiprocessing
                             .get_context("spawn")) as child:
        prof = child.submit(_wide_1m_profile).result()
    lo, hi = row["lifeguard_envelope_rounds"]
    lat = row["detection_latency_rounds"]["kernel"]
    res = {"row": row, "slot_drops": row["kernel_slot_drops"],
           "rounds": rounds, "seconds": wall,
           "rounds_per_s": rounds / wall,
           "max_memory_allocated": peak,
           "belief_matrix_bytes": p.slots * p.n,
           "round_counts": counts, "launches": launches, **prof}
    bad = []
    if not (row["completeness"]["kernel"] == 1.0
            and row["false_dead"]["kernel"] == 0
            and 0.8 * lo <= lat["p99"] <= hi):
        bad.append("outside the Lifeguard envelope's gates")
    if row["slots"] != 8192:
        bad.append(f"slots {row['slots']}, not loss_sized_slots' 8,192")
    if _round_bad(counts):
        bad.append("finish and probe launches")
    # The round at 8,192 slots launches every wide instance but the
    # spread's (no hist banks): each seen under the profiler.
    missing = [k for k, v in prof["wide_kernels_profiled"].items()
               if v == 0]
    if missing:
        bad.append(f"no {missing} under the profiler")
    res["bad"] = bad
    return res


def _close_round_programs() -> None:
    """Close every cached round program (a program at [8,192, 1M] holds
    its own buffers of the matrix) and free the memory."""
    from consul_tpu_torch.gossip import program
    _settle()
    while program._programs:
        _, prog = program._programs.popitem()
        prog.close()
    torch.cuda.empty_cache()


def _wide_launches() -> dict:
    """The four sources' launches since the last ``_reset_counts``
    (settled): each kernel's entry point count."""
    from consul_tpu_torch.gossip import finish, finish_slots, observe, probe
    _settle()
    return {"heard_counts": observe.launches,
            "fire_timers": finish.fire_launches,
            "wipe_rows": finish.wipe_launches,
            **{f"probe_{k}": getattr(probe, f"{k}_launches")
               for k in PROBE_KERNELS},
            **{f"finish_{k}": getattr(finish_slots, f"{k}_launches")
               for k in FINISH_SLOTS_KERNELS}}


def _wide_nemx() -> dict:
    """Path (b): ``run_nemesis_config`` for ``WIDE_NEMX_NAMES`` at n =
    4,096, its default slots (next_pow2(n) = 4,096), kernel side on the
    card, against the port's row on the CPU (``CROSSVAL_WIDE.json``,
    recorded by ``tools/wide_nemesis_rows.py``): every kernel field equal,
    and partition_heal's gates of crossval_nemesis."""
    from consul_tpu_torch.gossip import crossval
    recorded = json.loads((ROOT / "CROSSVAL_WIDE.json").read_text())
    if (recorded["n"], recorded["seeds"]) != (WIDE_NEMX["n"],
                                              WIDE_NEMX["seeds"]):
        raise AssertionError(f"CROSSVAL_WIDE.json holds n={recorded['n']}, "
                             f"seeds={recorded['seeds']}")
    rows, bad, card_s = {}, [], {}
    for name in WIDE_NEMX_NAMES:
        t1 = time.perf_counter()
        card = crossval.run_nemesis_config(name, WIDE_NEMX["n"],
                                           WIDE_NEMX["seeds"], oracle=False,
                                           device="cuda")
        card_s[name] = time.perf_counter() - t1
        rows[name] = recorded["rows"][name]
        bad += [f"{name}.{k}" for k in _kernel_fields_diff(card,
                                                           rows[name])]
        if card["slots"] != WIDE_NEMX["n"]:
            bad.append(f"{name}: slots {card['slots']}")
    # partition_heal's gates of crossval_nemesis on each model the row
    # has (its recorded row has no oracle's: intractable at n = 4,096).
    ph = rows["partition_heal"]
    for model in ("kernel", "refmodel"):
        if ph["member_frac_end"][model] is None:
            continue
        if not (ph["false_dead"][model] > 0
                and ph["member_frac_end"][model] >= 0.95):
            bad.append(f"partition_heal gate ({model})")
    if ph["kernel_slot_drops"] != 0:
        bad.append("partition_heal slot drops")
    return {"rows": rows, "card_s": card_s, "bad": bad}


def _wide_plane() -> dict:
    """The plane on the card at ``WIDE_PLANE``'s slots, its ticker
    running, until it has dispatched ``dispatches`` times; its tick
    errors (swallowed onto stderr) counted, and its kernels' launches."""
    from consul_tpu_torch.gossip import plane as gp

    async def ticked():
        cfg = gp.PlaneConfig(
            bind_port=0, capacity=32, sim_nodes=WIDE_PLANE["n"] - 32,
            slots=WIDE_PLANE["slots"], event_slots=8,
            gossip_interval_s=0.02, probe_every=5, suspicion_mult=1.0,
            hb_lapse_s=0.3, shard_devices=1)
        plane = gp.GossipPlane(cfg)
        await plane.start()
        try:
            r0 = int(plane._state.round)
            want = r0 + 4 * WIDE_PLANE["dispatches"]
            s = await _until(lambda: int(plane._state.round) >= want, 300,
                             f"{WIDE_PLANE['dispatches']} dispatches")
            return {"rounds": int(plane._state.round) - r0, "seconds": s,
                    "slots": plane._p.slots}
        finally:
            await plane.stop()

    err = io.StringIO()
    _reset_counts()
    try:
        with contextlib.redirect_stderr(err):
            res = asyncio.run(ticked())
    finally:
        sys.stderr.write(err.getvalue())
    res["tick_errors"] = err.getvalue().count("[gossip-plane] tick error")
    res["launches"] = _wide_launches()
    return res


def wide_slots_phase(card_line: str, cpu_parity: dict) -> dict:
    """The round at the reference's own slot provisioning, past the
    1,024 slots the four slot-sized sources once took in one block
    (``csrc/observe.cu``, ``finish.cu``, ``finish_slots.cu``,
    ``probe.cu``, each with a wide instance the host picks by S): each
    kernel against its plain version at ``WIDE_SHAPES`` (``_wide_kernels``),
    the chooser at 8,192 slots (``choose_vs_plain``'s shapes), the card's
    round against the CPU's under partition_heal at [2,048, 16,000] and
    [4,096, 16,000] on 1 and 8 shards (``_wide_parity``), path (a): the
    1M round at 5 % loss and 8,192 slots graphed (``_wide_1m``), path
    (b): run_nemesis_config at n = 4,096 against the port's recorded CPU
    rows (``_wide_nemx``), and the plane
    at 2,048 slots (``_wide_plane``)."""
    from consul_tpu_torch import sass_count
    from consul_tpu_torch.gossip import finish, finish_slots, observe, probe
    t0 = time.perf_counter()
    per_hash = sass_count.threefry_counts(sass_count.disassemble(
        "threefry"))["uniform"]["busiest_unit_per_element"]
    # The kernels' own checks are not a path's launches: path_shapes
    # replays only what the paths below launch.
    mods = (observe, finish, probe, finish_slots)
    shapes = [set(m.launch_shapes) for m in mods]
    kernels = _wide_kernels(per_hash)
    for m, before in zip(mods, shapes):
        m.launch_shapes.clear()
        m.launch_shapes.update(before)
    choose = choose_vs_plain()
    parity = _wide_parity(cpu_parity)
    emit({"phase": "wide_slots_parity", **parity})
    path_a = _wide_1m()
    emit({"phase": "wide_slots_1m", **path_a})
    path_b = _wide_nemx()
    emit({"phase": "wide_slots_nemesis", **path_b})
    plane = _wide_plane()
    emit({"phase": "wide_slots_plane", **plane})
    res = {"phase": "wide_slots", "card": card_line, "tolerance": 0,
           "max_abs_err": 0, "shapes": [list(s) for s in WIDE_SHAPES],
           "kernels": kernels, "choose_held": choose["held"],
           "parity_bad": parity["bad"], "path_a_bad": path_a["bad"],
           "path_b_bad": path_b["bad"],
           "plane_tick_errors": plane["tick_errors"],
           "path_a": {k: path_a[k] for k in (
               "rounds", "seconds", "rounds_per_s", "max_memory_allocated",
               "device_busy_ms_per_round", "device_span_ms_per_round",
               "slot_drops", "launches")},
           "seconds": time.perf_counter() - t0}
    emit(res)
    bad = ([f"parity at S={s}" for s in parity["bad"]]
           + path_a["bad"] + path_b["bad"])
    if plane["tick_errors"] or plane["slots"] != WIDE_PLANE["slots"] \
            or plane["launches"]["probe_lanes_slots"] == 0 \
            or plane["launches"]["heard_counts"] == 0:
        bad.append(f"plane at {WIDE_PLANE['slots']} slots: "
                   f"{plane['tick_errors']} tick errors, launches "
                   f"{plane['launches']}")
    if bad:
        raise AssertionError(f"wide_slots: {bad}")
    return res


def _wide_fields(wide: dict, name: str) -> dict:
    """A kernels-line entry's fields from the wide_slots phase: its
    launches on path (a) (the 1M round at 8,192 slots, every one a wide
    instance's) and its time, plain version's time and bound at each of
    ``WIDE_SHAPES``."""
    rows = wide["kernels"][name]
    return {"wide_launches": wide["path_a"]["launches"][name],
            "wide_ms": {k: r["ms"] for k, r in rows.items()},
            "wide_plain_ms": {k: r["plain_ms"] for k, r in rows.items()},
            "wide_bound_ms": {k: r["bound_ms"] for k, r in rows.items()}}


def _wide_cpu_submit(pool) -> dict:
    """The wide_slots phase's CPU side, submitted to ``pool``: the
    port's round on the CPU at ``WIDE_PARITY_S`` (S -> future)."""
    return {S: pool.submit(_nem_run_cpu, "partition_heal", WIDE_PARITY["n"],
                           S, WIDE_PARITY["steps"], WIDE_PARITY["seed"], 0,
                           WIDE_PARITY["first"])
            for S in WIDE_PARITY_S}


def flood_only() -> int:
    """``--phase event_flood``: the card line, the flood's build and SASS
    count, and the event_flood phase."""
    from consul_tpu_torch import _build
    card_line = card()
    _build.build("event_flood")
    for ln in _build.build_logs.get("event_flood", "").strip().splitlines():
        print(f"  nvcc event_flood: {ln}", flush=True)
    sass = flood_sass()
    emit({"phase": "sass", "flood": sass})
    flood_phase(card_line, sass)
    return 0


def observe_only() -> int:
    """``--phase observe``: the card line, the observers' kernel's build
    and the observe phase."""
    from consul_tpu_torch import _build
    card_line = card()
    _build.build("observe")
    for ln in _build.build_logs.get("observe", "").strip().splitlines():
        print(f"  nvcc observe: {ln}", flush=True)
    observe_phase(card_line)
    return 0


def finish_only() -> int:
    """``--phase finish``: the card line, the finish step's kernels'
    build and the finish phase."""
    from consul_tpu_torch import _build
    card_line = card()
    _build.build("finish")
    for ln in _build.build_logs.get("finish", "").strip().splitlines():
        print(f"  nvcc finish: {ln}", flush=True)
    finish_phase(card_line)
    return 0


def probe_only() -> int:
    """``--phase probe``: the card line, the builds the probe tick needs
    (``probe.cu``, ``threefry.cu`` for the SASS count of a hash) and the
    probe phase."""
    from consul_tpu_torch import _build
    card_line = card()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, ("probe", "threefry")))
    for name in ("probe", "threefry"):
        for ln in _build.build_logs.get(name, "").strip().splitlines():
            print(f"  nvcc {name}: {ln}", flush=True)
    probe_phase(card_line)
    return 0


def finish_slots_only() -> int:
    """``--phase finish_slots``: the card line, the builds the finish step
    needs (``finish_slots.cu``, the fire's and wipe's ``finish.cu``, the
    count's ``observe.cu``, the tail's ``dissem_tail.cu`` and the joined
    graph's ``round_graph.cu``) and the finish_slots phase."""
    from consul_tpu_torch import _build
    card_line = card()
    names = ("finish_slots", "finish", "observe", "dissem_tail",
             "round_graph")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    for name in names:
        for ln in _build.build_logs.get(name, "").strip().splitlines():
            print(f"  nvcc {name}: {ln}", flush=True)
    finish_slots_phase(card_line)
    return 0


def branch_only() -> int:
    """``--phase branch``: the card line, every build (the round runs every
    kernel) and the branch_check phase."""
    card_line = card()
    build()
    branch_check(card_line, **BRANCH)
    emit({"phase": "choose_alone", **choose_alone_ms()})
    return 0


def loop_only() -> int:
    """``--phase loop``: the card line, every build (the looped paths run
    every kernel) and the loop phase."""
    card()
    build()
    loop_phase()
    return 0


def draws_only() -> int:
    """``--phase draws``: the card line, the builds of the two threefry
    kernels (``threefry.cu``'s ``draw_kernel``, ``round_table.cu``'s
    ``table_kernel``; and a parent checkout's under ``build/parent``), the
    threefry phase and the table's checks and times
    (``table_vs_plain``)."""
    from consul_tpu_torch import _build
    card_line = card()
    with ThreadPoolExecutor(len(PARENT_SOURCES)) as pool:
        list(pool.map(_build.build, PARENT_SOURCES))
    for name in PARENT_SOURCES:
        for ln in _build.build_logs.get(name, "").strip().splitlines():
            print(f"  nvcc {name}: {ln}", flush=True)
    _parent_libs()
    threefry_phase(card_line)
    table_vs_plain()
    return 0


def wide_slots_only() -> int:
    """``--phase wide_slots``: the card line, every build (the wide
    paths run every kernel), the wide_slots phase with its CPU sides in
    worker processes, and the shapes its paths launched at held against
    the plain versions (path_shapes' checks of the four sources)."""
    from consul_tpu_torch.gossip import finish, finish_slots, observe, probe
    pool = ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu = _wide_cpu_submit(pool)
        card_line = card()
        build()
        for m in (observe, finish, probe, finish_slots):
            m.launch_shapes.clear()
        wide_slots_phase(card_line, cpu)
        rows = (observe_shapes_vs_plain(set(observe.launch_shapes))
                + finish_shapes_vs_plain(set(finish.launch_shapes))
                + probe_shapes_vs_plain(set(probe.launch_shapes))
                + finish_slots_shapes_vs_plain(
                    set(finish_slots.launch_shapes)))
        emit({"phase": "wide_slots_path_shapes", "shapes": rows,
              "tolerance": 0})
    finally:
        pool.shutdown(cancel_futures=True)
    return 0


PHASES_ALONE = {"event_flood": flood_only, "observe": observe_only,
                "finish": finish_only, "probe": probe_only,
                "finish_slots": finish_slots_only, "branch": branch_only,
                "loop": loop_only, "draws": draws_only,
                "wide_slots": wide_slots_only}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "consul_tpu_torch").is_dir():
        print("chip_smoke: the port package consul_tpu_torch is not beside "
              "this script; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    if sys.argv[1:]:
        if len(sys.argv) != 3 or sys.argv[1] != "--phase" \
                or sys.argv[2] not in PHASES_ALONE:
            print("usage: chip_smoke.py [--phase "
                  "event_flood|observe|finish|probe|finish_slots|branch|"
                  "loop|draws|wide_slots]",
                  file=sys.stderr)
            return 2
        try:
            return PHASES_ALONE[sys.argv[2]]()
        except Exception:
            traceback.print_exc()
            return 1
    t_start = time.perf_counter()
    # The CPU runs that the card's runs are held against, and the oracle's
    # seeds, go to worker processes at once (one thread each), and compute
    # while the card's phases run; every one has finished before the first
    # timed main path.
    pool = ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_full = pool.submit(_full_path_cpu, **FULL_PATH)
        cpu_nem = {name: pool.submit(_nem_run_cpu, name, NEM["n"], NEM["S"],
                                     steps, NEM["seed"])
                   for name, steps in NEM_STEPS.items()}
        # Longest first: asym_loss's oracle is the longest CPU task.
        cpu_nemx = {name: pool.submit(_nemx_cpu, name, **NEMX)
                    for name in ("asym_loss", "partition_heal",
                                 "degraded_observer", "block_kill",
                                 "flapping", "zone_kill")}
        cpu_seed0 = pool.submit(_seed0_cpu)
        cpu_mdc = {hot: pool.submit(_mdc_cpu, hot, **MDC) for hot in (0, 8)}
        cpu_wide = _wide_cpu_submit(pool)
        card_line = card()
        build()
        _parent_libs()
        tf = threefry_phase(card_line)
        sass = sass_phase()
        big = kernel_vs_plain(64, 1_000_000, seed=1, sass=sass)
        kernel_vs_plain(8, 1_000_000, seed=2, sass=sass)
        kernel_vs_plain(64, 16_001, seed=5, sass=sass)
        # The multi-DC LAN pools (250,000 a DC, the hot tier's 8 rows) and
        # the crossval widths.
        kernel_vs_plain(64, 250_000, seed=21, sass=sass)
        kernel_vs_plain(8, 250_000, seed=22, sass=sass)
        kernel_vs_plain(64, 10_000, seed=23, sass=sass)
        kernel_vs_plain(64, 1_000, seed=24, sass=sass)
        mbig = merge_vs_plain(64, 1_000_000, 8, seed=3, sass=sass)
        merge_vs_plain(8, 1_000_000, 8, seed=4, sass=sass)
        for ndev in (1, 2, 4, 8):
            merge_vs_plain(64, 16_000, ndev, seed=6 + ndev, sass=sass)
        merge_vs_plain(64, 250_000, 8, seed=25, sass=sass)
        merge_vs_plain(8, 250_000, 8, seed=26, sass=sass)
        merge_vs_plain(64, 10_000, 8, seed=27, sass=sass)
        repeat(8, 1_000_000, seeds=256)
        repeat(8, 1_000_000, seeds=128, ndev=8)
        repeat(64, 1_000_000, seeds=16)
        flood = flood_phase(card_line, sass["flood"])
        counts = observe_phase(card_line)
        fin = finish_phase(card_line)
        probed = probe_phase(card_line)
        fslots = finish_slots_phase(card_line)
        # From here on every launch is a path's: its shapes are held
        # against the plain version after the last path.
        from consul_tpu_torch import prng
        from consul_tpu_torch.gossip import (events, finish, finish_slots,
                                             fused, observe, probe)
        events.launch_shapes.clear()
        finish_slots.launch_shapes.clear()
        probe.launch_shapes.clear()
        fused.launch_shapes.clear()
        observe.launch_shapes.clear()
        finish.launch_shapes.clear()
        prng.launch_shapes.clear()
        prng.launch_groups.clear()
        single = full_path(cpu_full, **FULL_PATH)
        sharded_full_path(single, **FULL_PATH)
        del single
        branch = branch_check(card_line, **BRANCH)
        loop = loop_phase()
        nemesis_full_path(cpu_nem, **NEM)
        cross = crossval_phase(pool, cpu_seed0)
        # The device store's CPU sides, once the crossval phase's oracle
        # seeds are through the workers: apply_ref over the whole stream
        # (one sequential chain) first, then match_batch over chunks of
        # the watch sets.  They finish while the phases up to
        # multidc_full_path run; the device_store phase reads them.
        store_cpu = pool.submit(_store_apply_cpu, STORE["capacity"],
                                STORE["probe"], STORE["seed"])
        watch_oracle = {W: [pool.submit(_watch_oracle, W, lo, hi,
                                        WATCH["events"], WATCH["seed"])
                            for lo, hi in _oracle_chunks(W, ORACLE_CHUNK)]
                        for W in WATCH_W}
        bridge_oracle = [pool.submit(_bridge_oracle, lo, hi, **BRIDGE)
                         for lo, hi in _oracle_chunks(BRIDGE["watches"],
                                                      BRIDGE_CHUNK)]
        crossval_nemesis_phase(cpu_nemx, **NEMX)
        multidc_full_path(cpu_mdc, **MDC)
        wide = wide_slots_phase(card_line, cpu_wide)
        t_wait = time.perf_counter()
        pool.shutdown()
        emit({"phase": "cpu_workers_done",
              "wait_s": time.perf_counter() - t_wait})
        churn, churn_state = main_path(1_000_000, 64, 1000, warm=50,
                                       block=100, blocks=3)
        _churn_gates(churn, "kernel_launches")
        sharded, sharded_state = main_path(1_000_000, 64, 1000, warm=50,
                                           block=100, blocks=3, ndev=8)
        _churn_gates(sharded, "merge_launches")
        if sharded["host_syncs_per_round"] != churn["host_syncs_per_round"]:
            raise AssertionError("the sharded round reads the device more "
                                 "often than the single-device round")
        diverged = _diverged([(churn_state, sharded_state)])
        emit({"phase": "sharded_main_path_parity", "diverged": diverged,
              "rounds_per_s_mean": {"single": churn["rounds_per_s_mean"],
                                    "sharded": sharded["rounds_per_s_mean"]}})
        if diverged:
            raise AssertionError(f"sharded and single-device 1M churn runs "
                                 f"diverged in {diverged}")
        del churn_state, sharded_state
        # The same churn with the flight ring, hist banks and trace
        # threaded (the observers' kernel), on 1 and 8 shards.
        obs1, obs1_carry = main_path(1_000_000, 64, 1000, warm=20,
                                     block=100, blocks=3, observers=True)
        obs8, obs8_carry = main_path(1_000_000, 64, 1000, warm=20,
                                     block=100, blocks=3, ndev=8,
                                     observers=True)
        diverged = _diverged(list(zip(obs1_carry, obs8_carry)))
        emit({"phase": "sharded_observers_main_path_parity",
              "diverged": diverged,
              "rounds_per_s_mean": {"single": obs1["rounds_per_s_mean"],
                                    "sharded": obs8["rounds_per_s_mean"]}})
        if diverged:
            raise AssertionError(f"sharded and single-device 1M churn runs "
                                 f"with observers diverged in {diverged}")
        del obs1_carry, obs8_carry
        main_path(1_000_000, 64, 0, warm=20, block=100, blocks=3)
        nem1, nem1_state = nemesis_main_path()
        nem8, nem8_state = nemesis_main_path(ndev=8)
        if nem8["host_syncs_per_round"] != nem1["host_syncs_per_round"]:
            raise AssertionError("under nemesis the sharded round reads the "
                                 "device more often than the single-device "
                                 "round")
        diverged = _diverged([(nem1_state, nem8_state)])
        emit({"phase": "sharded_nemesis_main_path_parity",
              "diverged": diverged})
        if diverged:
            raise AssertionError(f"sharded and single-device 1M "
                                 f"partition_heal runs diverged in "
                                 f"{diverged}")
        del nem1_state, nem8_state
        rp = round_program_phase(card_line)
        ev = events_phase()
        crossval_1m_phase()
        mdc1, mdc1_states = multidc_main_path()
        mdc8, mdc8_states = multidc_main_path(lan_devices=8)
        # The final states, after the first LAN detections: the parity
        # covers DEAD verdicts on the 31,250-column shards.
        diverged = _mdc_state_diff(mdc1_states[-1], mdc8_states[-1])
        detected = mdc8["n_detected"]
        emit({"phase": "sharded_multidc_main_path_parity",
              "rounds": mdc8["rounds"], "diverged": diverged,
              "n_detected": detected,
              "rounds_per_s_mean": {
                  "single": mdc1["rounds_per_s_mean"],
                  "sharded": mdc8["rounds_per_s_mean"]}})
        if diverged:
            raise AssertionError(f"sharded and single-device 1M multi-DC "
                                 f"runs diverged in {diverged}")
        if min(detected) == 0:
            raise AssertionError(f"the 1M multi-DC parity saw no DEAD "
                                 f"verdict in some DC: {detected}")
        del mdc1_states, mdc8_states
        plane1 = plane_phase(1, full=True)
        plane8 = plane_phase(8, full=False)
        plane_nem = plane_nemesis_phase()
        gossipd_phase()
        from consul_tpu_torch.state import device_store as tds
        tds.launch_shapes.clear()
        store = store_phases(store_cpu, watch_oracle, bridge_oracle,
                             card_line)
        path_shapes_vs_plain(set(fused.launch_shapes),
                             set(tds.launch_shapes),
                             set(prng.launch_shapes),
                             set(events.launch_shapes),
                             set(observe.launch_shapes),
                             set(finish.launch_shapes),
                             set(probe.launch_shapes),
                             set(finish_slots.launch_shapes))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        pool.shutdown(cancel_futures=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    slot_rows = [
        _observe_row(counts, obs1, obs8, rp, plane1, cross),
        *_finish_rows(fin, churn, sharded, plane1, cross, mdc1, rp),
        *_probe_rows(probed, churn, sharded, nem1, plane1, cross, mdc1, rp),
        *_finish_slots_rows(fslots, churn, sharded, obs1, plane1, cross,
                            mdc1, rp)]
    for row in slot_rows:
        row.update(_wide_fields(wide, row["name"]))
    emit({"kernels": [{
        "name": "fused_dissem", "route": "cuda",
        "source": "consul_tpu_torch/csrc/dissem_tail.cu",
        "replaces": "consul_tpu/gossip/fused.py:141",
        "launches": churn["kernel_launches"],
        "plane_launches": plane1["dissem_launches"],
        "nemesis_launches": nem1["drop_launches"],
        "plane_nemesis_launches": plane_nem["drop_launches"],
        "crossval_launches": cross["dissem_launches"],
        "multidc_launches": mdc1["dissem_launches"],
        "max_abs_err": big["max_abs_err"], "ms": big["ms"],
        "share_of_bound": big["share_of_bound"], "ms_drop": big["ms_drop"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_ms_drop": big["bound_ms_drop"],
        "bound_by": big["bound_by"], "library_ms": None}, {
        "name": "fused_merge", "route": "cuda",
        "source": "consul_tpu_torch/csrc/dissem_tail.cu",
        "replaces": "consul_tpu/gossip/fused.py:199",
        "launches": sharded["merge_launches"],
        "plane_launches": plane8["merge_launches"],
        "nemesis_launches": nem8["merge_drop_launches"],
        "multidc_launches": mdc8["merge_launches"],
        "max_abs_err": mbig["max_abs_err"], "ms": mbig["ms"],
        "share_of_bound": mbig["share_of_bound"],
        "ms_drop": mbig["ms_drop"],
        "plain_ms": mbig["plain_ms"], "bound_ms": mbig["bound_ms"],
        "bound_ms_drop": mbig["bound_ms_drop"],
        "bound_by": mbig["bound_by"], "library_ms": None},
        _store_kernel_row("kv_apply", store), _store_kernel_row(
            "watch_match", store), {
        "name": "threefry", "route": "cuda",
        "source": "consul_tpu_torch/csrc/threefry.cu",
        "replaces": "consul_tpu/gossip/kernel.py:972",
        # The path that draws: the nemesis main path's edge drops (the
        # probe tick draws inside its own kernel since probe.cu).
        "launches": nem1["draw_launches"],
        "churn_launches": churn["draw_launches"],
        "nemesis_launches": nem1["draw_launches"],
        "crossval_launches": cross["draw_launches"],
        "multidc_launches": mdc1["draw_launches"],
        "max_abs_err": tf["summary"]["max_abs_err"],
        # A 1M partition_heal round's gossip legs' drops, [3, 1M], its
        # keys and shifts read from device memory (the launch it makes).
        "ms": tf["summary"]["main_path_ms"],
        "by_value_ms": tf["summary"]["main_path_by_value_ms"],
        # The parent checkout's kernel in the same call (null without one).
        "parent_ms": tf["summary"]["main_path_parent_ms"],
        "plain_ms": tf["summary"]["main_path_plain_ms"],
        "plain_graph_ms": tf["summary"]["main_path_plain_graph_ms"],
        "bound_ms": tf["summary"]["main_path_bound_ms"],
        "bound_by": tf["summary"]["main_path_bound_by"],
        "share_of_bound": tf["summary"]["main_path_bound_ms"]
        / tf["summary"]["main_path_ms"],
        "library_ms": None}, _round_graph_row(rp, churn),
        _choose_row(branch, churn, sharded, rp, mdc1, plane1, cross),
        *_loop_rows(loop, churn, sharded, rp, mdc1, plane1, cross),
        _flood_row(flood, mdc1, mdc8, ev, plane1), *slot_rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
