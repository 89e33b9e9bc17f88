#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tnl_lbm_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's dispatch paths through the CUDA kernels: the A-A duct
(D3Q27 CUM_WELL on a square duct) per step (even/odd kernels) and in pairs
(the one-kernel pair, with the state in float32, float16 or bfloat16), and
the A-B step (B4) with the full 3D boundary set, on the bench duct and in
sim_1, sim_2 and sim_3; the A-A even/odd kernels (B2, B3) with the 3D set
and the three variants in sim_1 ``--streaming AA``; the coupled NSE+ADE
path - the ADE step (B6), the one-kernel coupled step (B7) and, with A-A
streaming, the A-A coupled pair (B8) - in sim_coupled; the D2Q9 step (B5)
with the Bouzidi curved walls in sim2d_1, sim2d_2 and sim2d_3, held to the
TPU-measured golden KE corpus; the forcing-hook path - the non-Newtonian
force through the one-kernel NN step (B10) or the pipeline of the u* pass
(the macro_only variants of B4, B2/B3), the NN force kernel (B9) and the
force_field variants (B4, B2/B3, B5) - in ``Simulation`` and
``CoupledSimulation``; the port's benchmark entry (``python -m
tnl_lbm_tpu_torch.bench``) through the one-kernel pair (B1) and the
full-set pair (B1b); the site-major A-B step (B4s) and the window probes
(P3, P4).  Each phase prints result lines; any failing phase raises and the
script exits non-zero without printing a result.

1. device: the card, ``nvidia-smi`` name and power limit, torch/CUDA
   versions, its SM count and maximum SM clock (``clocks.max.sm``), and so
   its FP32-pipe and SFU issue rates;
2. build: compile the kernels from ``tnl_lbm_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel, alone on the host's cores: the library's cold
   build; registers, shared memory and spills from ``-Xptxas -v``, and the
   pair's dynamic shared memory); then, beside the first compares, the
   FP32-pipe and SFU instructions per thread of each kernel from
   ``cuobjdump -sass`` (a subprocess), each one slot and every branch once,
   the upper bound of what a site issues that the bound of the JSON record
   uses, with the B5 variants and the collisions' site work (build_rest);
3. compare, kernels against their plain PyTorch versions on the card, with
   the JAX suite's bounds (tests/test_fused_kernel.py:65-67): |df| <= 1e-6
   (for a 16-bit state ``utils.dtypes.state_agrees``: one unit in its last
   place plus 2e-8, and at most 0.1% of the elements different at all),
   |drho| <= 2e-6, |du| <= 1e-6:
   a. even/odd: sim_2's res-2 duct (32x64x64, WALL + NOTHING, periodic x),
      4 alternating steps; then one step of each at 256^3, timed, the odd
      step's lean CUM_WELL instance beside the full-set one; then a box of
      every A-A code with Z = 150, per variant (CUM_WELL; CUM with
      eq_quadratic or eq_inv_cum), 4 alternating steps each from the same
      input on both sides;
   b. pair, per store dtype: two pairs on the res-2 duct, each from the
      same input on both sides, and for a 16-bit state the float32 kernel's
      output on the widened input, narrowed, equal to the 16-bit kernel's
      bit for bit (the narrowing rounds to nearest even exactly); the same
      on PAIR_BOXES (shapes no column tile or x segment divides, X shorter
      than a segment, a z extent read without staging, NOTHING sites, three
      periodic combinations); then one pair at 256^3, checked the same ways
      and timed beside one even plus one odd launch, with effective GB/s at
      233 B/site per pair (125 B/site with 16-bit storage), and the kernel's
      launch geometry (shared memory, stages, x segments);
   c. the A-B step, after phase 4 so that it is timed beside P1: one step
      from a seeded random state on sim_2 res 2 A-B (CUM_WELL), sim_1 res 2
      (CUM, eq_inv_cum), sim_3 res 2 (CUM, eq_quadratic) and a box holding
      every code of the 3D set with a Z that the block's 128 z sites do
      not divide (CUM_WELL, then CUM); then one step at 256^3 on the bench
      duct, timed over 20 launches (plain: 3 calls) beside one even and one
      odd launch and the P1 floor, GB/s at 233 B/site;
   d. the ADE step (B6): one step from a seeded state against its plain
      version (|dg| <= 1e-6, |dphi| <= 2e-6) on sim_coupled's res-2 ADE
      map, on a box holding every ADEGEO code with a transfer coefficient
      of 0.3, and on a periodic box with Z = 150, under the four
      collisions with a scalar and a per-site nu;
   e. the coupled step (B7): one step against its plain version and
      against the A-B kernel then the ADE kernel on the same inputs, on
      sim_coupled's res-2 maps and on the two boxes, per NSE variant and
      ADE collision (f, rho, u to the A-B bounds, g and phi to B6's),
      printing whether B7 equals B4 then B6 bit for bit; then B6, B7 and
      B4 followed by B6 timed at 256^3 (the bench duct, with WALL faces
      on the ADE lattice too) beside B4 and the P1 floor, GB/s at 73,
      294 and 306 B/site; then B8, even and odd parity from the same input,
      against its plain version and its NSE fields against B2/B3 run alone
      (bit-equality printed) on sim_coupled's res-2 A-A maps, a box whose
      NSE and ADE NOTHING sites differ and the periodic box, per NSE
      variant and ADE collision with a nu field; B8 even and odd timed at
      256^3 on the coupled bench duct under A-A beside B2 + B3, GB/s at 294
      B/site;
4. probes: the copy floor P1 at 256^3 (GB/s at 232 B/site, share of the
   published 3.35 TB/s), the march's memory half P2a through each load
   path (the staged rows, direct reads, the TMA plane ring) bit for bit
   and P2b at 256^3 with 0, 20 and 60 passes, held against their plain
   versions, P2a's paths timed with GB/s at 216 B/site and at the windows'
   bytes, their share of P1, 20 passes over 0 and B1 f32's time of 3b;
   the element pipeline P3 (scripts/probe_element_pipeline.py's four
   (tile, passes) variants) and the window copy P4 (the six covering
   windows of scripts/probe_dma_align.py, each through 4-byte loads,
   16-byte loads and TMA) on a padded [27, 260, 272, 256] state, their
   interiors bit-equal to the plain versions', and P4's seventh window,
   which does not cover its tile, raising; then all timed, P3's four
   variants with their march geometry and, beside the passes-0 ones, P3's
   function at 0 passes as one PyTorch call (the interior copied into a
   padded buffer) before and after; whether P3 hides its passes (its time
   at 20 and 60 passes less its time at 0, against P2b's compute-only time
   at as many passes, and the same of P2a's three paths); P2b (the march's
   compute half: a persistent grid over its column tiles and x segments)
   with its launch geometry, its SASS FP32 instructions per thread beside
   the 2 x 27 a pass and site the bound counts, and its share of the bound
   at 0, 20 and 60 passes; P2a's function at 0 passes as one PyTorch call
   (``out.copy_(f)``) before and after its paths; P4's library call
   (``interior(fpad).contiguous()``) before and after each covering
   window's three loads, with the ring's plane buffers;
   layouts (after 3c): the full-set A-A pair B1b (one launch a pair) on
   sim_2's res-2 duct, on the box of every A-A code per variant and on
   sim_1's A-A map at res 4, two pairs from the same input on both sides,
   and an x segment starting at X - 1 bit for bit the same; at 256^3
   against its plain version and timed in turns beside B1 f32, with B2 +
   B3 of 3a beside it; on sim_1's A-A map at res 8 timed in turns beside
   one even and one odd launch of the same instances, then sim_1 res 8
   ``--streaming AA`` through ``Simulation``: built with
   ``pair_dispatch="auto"`` (the probe's two times and its pick, rechecked
   over longer chains as on the bench duct), then a paired run (B1b) and a
   per-step run (B2/B3) from the same start, their ``_advance`` chunks
   (graph replays after the first three) in turns, the MLUPS of each,
   their f, rho and u within 1e-5 of each other and the launches one a
   pair; the
   site-major A-B step B4s on 3c's cases (dummy components zero), then at
   256^3 against its plain version and timed beside B4;
5. main paths, each with the launch counts set to 0 just before it and read
   just after: ``Simulation`` on the 256^3 bench duct, 200 per-step A-A
   dispatches; ``pair_dispatch="auto"`` (the probe's choice and its two
   times beside both routes timed again by its helper over longer chains,
   here and on sim_2 res 2: where the routes differ by more than 10% the
   choice must be the faster); 200 steps in pairs with the state in f32, f16 and bf16; 200
   A-B steps; sim_1 at resolution 8 (1024x256x256), 100 A-B steps, with
   one VTK2D cycle written and read back.  Each gives ms/step, MLUPS
   (X*Y*Z*steps / compute time), peak memory, kernel launches (> 0),
   plain calls (0) and finite rho/u.  Last, one A-B step from sim_1's
   final state at resolution 8, the kernel against its plain version
   with the step bounds (the launches of this compare are not counted).
   Then sim_coupled at resolution 8 (512x256x256), 100 steps with
   ``--use-fused``: ``coupled_kernel`` must be "one-kernel-AB" with 100
   coupled launches; phi finite; on the band of y more than 100 sites from
   the WALL_BODY walls (the JAX app's anti-bounce-back walls grow phi
   about 1.9x per step, and in 100 steps nothing from them reaches the
   band) rho, u and phi equal the plain steps' on a periodic X x 4 x 4
   slab within 1e-5, phi <= 1 + 1e-3 and above zero at x = 1; one step from
   its final state, kernel against plain (g and phi relative to the
   largest magnitude the site's update reads, at least 1); then the same
   run through the two-kernel path (B4 then B6, 100 launches each)
   against the one-kernel run's fields, then with ``--streaming AA``
   through B8 ("one-kernel-AA", 50 even and 50 odd launches, the band held
   to an A-A slab, one even and one odd parity from the final state kernel
   vs plain, ms/step, MLUPS and peak memory beside the A-B run's); after
   each run, torch.profiler over 10 more steps: device time per kernel
   and the device's busy share of the loop.  Also sim_1 at resolution 8
   with ``--streaming AA`` and pair dispatch off, 100 steps through B2/B3
   (the pair-dispatched run is the layouts phase's), and the kernel vs
   plain check of one even and one odd step from a res-4 run's final
   state (the plain A-A step's temporaries at res 8 would not fit beside
   the run); then the benchmark entry (``tnl_lbm_tpu_torch.bench``'s
   ``main``, its JSON line parsed): pair2 in f32, f16 and bf16 and pair
   (B1b, one launch a pair), 50 timed pairs each from the rest state at 256^3, every kernel's
   launch count > 0 and no plain call;
   collisions (right after the main paths above, before the bench entry):
   the per-step kernels' instances of the other sixteen D3Q27 collisions
   (csrc/coll_*.cu: SRT, SRT_WELL, SRT_MODIF_FORCE, BGK, BGK_WELL, MRT_LES,
   CLBM, CLBM_WELL, KBC N1-N4 and C1-C4), each against its plain version on
   ``bc_box((24, 20, 150))`` (one A-B step) and ``aa_box`` (one even, then
   one odd step) with its natural equilibrium, KBC_N1 also with
   ``eq_entropic`` and SRT with ``eq_inv_cum`` (|df| <= 1e-6, 1e-5 under
   KBC); then each id through ``Simulation`` on the 256^3 bench duct, A-B
   and A-A per step (pair dispatch off), 100 steps each with the counts set
   to 0 at the end of sim_init and read after (one launch a step, no pair,
   no plain call): MLUPS, and each kernel timed over 20 launches on the
   run's final state and on a seeded developed state, GB/s at 233 B/site
   against P1, registers and spills;
   collision_routes (after the IBM run): the same collisions and CUM with
   ``eq_entropic`` on the kernels of the hooked routes and of pair
   dispatch - the force_field instances of B4, B2/B3 (csrc/coll_*.cu), the
   one-kernel NN step B10 (csrc/nn_coll_*.cu) and the full-set pair B1b
   (csrc/pair_coll_*.cu): each instance against its plain version (the
   force_field steps on ``bc_box((24, 20, 150))`` / ``aa_box`` with a
   seeded per-site force of ~1e-5, B10 A-B, even and odd on the wall duct
   with CY(0.1, 1, 2, 0.5), B1b on ``aa_box`` over several x segments) at
   the step bounds, KBC too; each timed at 256^3 on a seeded developed
   state (20 launches; GB/s against P1, the bound, registers, spills); then
   under MRT_LES, KBC_N1 and SRT_MODIF_FORCE, 100 steps each through
   ``Simulation``: the bench duct A-A with ``pair_dispatch="auto"`` (the
   probe's two times and choice, checked against longer chains, B1b's
   launches, MLUPS) and the hooked 256^3 duct A-B and A-A from a duct
   profile through the plain hooked step, B10 and the pipeline with the
   same hook, each route's f, rho and u within 1e-5 of the plain run's
   (KBC_N1: 1e-4, the repo's KBC factor of ten);
   last sim_ibm res 1 under MRT_LES, 20 steps, kernel against plain with
   the CG pinned, within 1e-5;
6. the 2D slice (after the main paths; the D2Q9 kernel's bounds as the
   step compares'):
   a. compare_2d: B5 against its plain version at 37 x 150 (neither a
      multiple of the block) on sim2d_2's channel, the channel with a WALL
      block in a Bouzidi ring (seeded thetas in (0.05, 0.95) on the links
      that hit it, -1 on the others), the periodic-x channel and a box of
      every code B5 takes with ring sites on the domain edge; SRT and CLBM,
      force absent and present, the inflow as a vector and as a [2, 1, Y]
      profile on the card; one step from the same input, then 4 chained
      steps on each side compared at the end;
   b. golden_2d: sim2d_3 at resolution 1 to t = 0.4 (1440 steps) through
      B5 on all 108 rows of tests/golden/geometry_ke_values_tpu.csv, the
      geometries written by scripts/make_golden_geometries.py; the 12 rows
      the JAX suite samples within 1e-4 relative; the worst row over the
      108 and the count beyond 1e-4 printed; 1440 launches and 0 plain
      calls per row; geometry 1 with Bouzidi again with each 20-step chunk
      one launch of B5's resident chunk (``torch_cases.resident_route``:
      72 launches, no step launch), bit for bit the per-step run (KE
      value, f, rho, u); on its state, B5's two kernels at 128 x 32: 20
      step launches against one chunk bit for bit, the chunk against its
      plain version, ms per launch and per step of both, and the chunk's
      sync floor and clusters of 8 and 4 blocks (variants built from
      tests/b5_chunk_ablation.py beside the library); the two routes in 10
      alternating pairs through ``Simulation._advance`` and as whole rows;
      then a row's host time in parts (build, sim_init, the eager chunk,
      the capture, the replays, the KE) with the cyclic collector running
      and frozen, and its full collections;
   c. apps_2d: sim2d_3 res 2 (geometry 1's disk scaled by 2 in a seeded
      ring), sim2d_1 res 4 with ``--use-fused`` (its VTK2D cut read back)
      and sim2d_2 res 1 on geometry 1 with Bouzidi (the statistics state
      machine compressed, from step 150), each through B5 and through the
      plain step on the card from the same start: rho and u within 1e-5,
      sim2d_2's accumulators, counts, events and TKE too; one B5 launch
      per step;
   d. time_2d: sim2d_3's channel at resolution 64 (8192 x 2048, the site
      count of 256^3) with geometry 1's disk scaled by 64 in a seeded
      ring: 200 steps through ``Simulation`` (MLUPS, peak memory), the
      profiler's busy share over 10 more; on the state after the 200, B5
      timed in three windows of 20 launches (the median; the card's clocks
      beside them) and against its plain version (one step; plain: 3
      calls, its peak memory), GB/s at the 85 B/site this data needs
      (plus the ring's thetas and the profile) against P1;
7. the forcing-hook slice (``phase_compare_hooked`` right after the build,
   the rest after the 3D main paths; the 2D run after the 2D slice):
   a. compare_hooked: B9 (Carreau-Yasuda and Casson, the hook wrapped as
      the domain and not; |dF| <= 1e-6 of max |F|), B10 (A-B, A-A even and
      odd, 4 chained steps; the hook wrapping z where the domain does not)
      on a wall duct, a periodic box with a ragged Z and a closed box with
      an obstacle; the force_field and macro_only variants of B4 and B2/B3
      on those and on the boxes of every code; B5's force_field variant on
      the 2D channels - each against its plain version with the step bounds;
   b. main_hooked: the 256^3 bench duct with ``CarreauYasuda(0.1, 1, 2,
      0.5)`` (scripts/bench_hooked.py), an evolved state (100 one-kernel
      A-B steps from rest), then 100 steps each through ``Simulation``: A-B
      and A-A on the one-kernel route (the hook wrapped as the domain) and
      on the pipeline (the hook without ``periodic``), each with ms/step,
      MLUPS, peak memory, launches (every step through its route, 0 plain
      calls), the sampled phase times, the profiler's busy share over 10
      more steps, one step from the final state against the plain hooked
      step, the route's kernels timed (20
      launches; plain: 3 calls) with GB/s and registers, and on the
      one-kernel routes the pipeline with the same hook held to B10;
   c. blunt: the Carreau-Yasuda channel of JAX
      tests/test_non_newtonian.py:42-78 (4 x 4 x 21, CUM_WELL f32) through
      B10 and its Newtonian twin through B4, 3000 + 1 steps: the shape
      factor must drop by more than 0.01, and each lie within 1e-3 of the
      JAX XLA step's value;
   d. coupled_hooked: sim_coupled res 2 with the hook ("two-kernel": the
      hooked A-B step, then B6), 100 steps against the plain coupled run,
      and one step against the plain steps;
   e. hooked_2d: sim2d_3's res-64 channel with the hook, 100 steps (the
      plain u* pass and hook, then B5's force_field variant), one step
      against the plain hooked step, B5's force_field variant timed;
8. accuracy: sim_2 res 2 run to its stopping point per step and in pairs
   (f32), and with A-B streaming through the A-B kernel; each L1 error must
   lie within 5% of the L1 that the analytic start-up solution of the duct
   (``sim_2.duct_startup_ux``) has at the same iteration.  Then
   ``--storage f16`` and ``--storage bf16``: their L1 beside the f32 pair
   run's at the same iteration; a non-finite result fails.  The JAX
   package's recorded 1.074e-4 (docs/PERFORMANCE.md:58) is a reading of
   this transient near t = 5 s and is printed for comparison.  Last, sim_1
   res 2 and sim_3 res 2, 100 steps each through ``Simulation`` with the
   A-B kernel and with the plain step on the card, from the same start:
   max |drho| and max |du| <= 1e-5, and sim_1 res 2 A-A through B2/B3;
   sim_coupled res 2 likewise through the coupled kernel and the plain
   steps, A-B (B7) and A-A (B8), with |dphi| <= 1e-5 relative to the
   largest |phi| within a site's reach, at least 1.
9. dispatch_and_checkpoint (after the 2D hooked run, before the accuracy
   runs): the driver's chunked dispatch, which the main paths above already
   take (a chunk the gate admits runs once eagerly, is captured as a CUDA
   graph per start buffer, then replayed, each replay adding its launches
   to the counts), held to the same chunks run eagerly from the same state
   and buffers, bit for bit with the same launches, on one golden row's B5
   (sim2d_3 res 1, and with the hook: the plain u* pass and hook, then B5's
   force_field variant), sim_2 res 2 in pairs (f32 and f16), per step and A-B
   (both statistics windows on), sim_1 res 2 A-A and the 256^3 hooked duct
   on both routes, A-B and A-A; checkpoint round trips (3 chunks, a
   background ``save_state``, a run resumed from it and 3 more chunks,
   against 6 uninterrupted, bit for bit) on sim_2 res 2 in pairs and A-B
   with the statistics, sim_coupled res 2 (g and phi) and sim2d_2 res 1 (its
   running sum); then, in turns, the golden sweep's wall per row with B5
   per step from its graph and from Python and through the resident
   chunk, B5's ms per step through ``Simulation._advance`` per step from
   its graph or eager and with the resident chunk replayed from its graph
   or launched directly, and sim_2 res 2's MLUPS in pairs and per step
   with the graph and per step from Python.

10. ibm (after the coupled hooked run): sim_ibm at resolution 4
   (384x128x128, a cylinder of 25 098 points, phi2 "modified": the
   point-space ELLPACK operator), 200 steps through the hooked A-B pipeline
   (B4 macro_only, the IBM solve as tensor ops, B4 force_field with the
   inflow vector; 200 launches of each, no plain call): its setup (points,
   spacing, operator space, unique nodes, build seconds), ms/step from the
   host clock and the median of per-step CUDA-event times, MLUPS, the
   sampled phase split, the CG iterations and residual over the steps (min
   / median / max), peak memory, the drag line, finite rho and u, and
   torch.profiler's device time of B4 and of the hook per step; one step
   from the run's final state and one from the flow at the inflow velocity,
   kernel against plain hooked step with the CG pinned (8 iterations) at
   the step bounds; sim_ibm res 2, 100 steps through the kernels and
   through the plain hooked step, CG pinned, rho and u within 1e-5, and
   the kernel run in 10-step chunks (eager: the hook reads the host, so no
   graph) within 1e-5 of it; one row of the IBM table (phi2, 4 096 points
   on 96^3, both methods; ``python -m tnl_lbm_tpu_torch.ibm_tables``).
   B4's two instances add the res-4 run's launches to the record.

11. double_and_profile (after the accuracy runs, whose float32 L1 it reads):
   the float64 instances of sim_2's path and B4's profile instance.  The
   instances' registers, spills and their SASS FP32, SFU and FP64
   (DFMA, DADD, DMUL) slots per thread; each against its plain version
   (float64 at |df| <= 1e-12, |drho| <= 2e-12, |du| <= 1e-12, float32 at
   the step bounds): B4 float64 and B4's profile instance (float32,
   float64; [3, 1, Y, Z] and [3, X, Y, Z] profiles) on ``bc_box((24, 20,
   150))``, two steps with an inflow velocity and a force that float32
   cannot hold; B2/B3 float64 on sim_2's res-2 duct (the lean odd
   instance) and on ``aa_box``, four steps; B1 float64 on sim_2's res-2
   duct and a 20x36x40 duct box in x segments of 7, closed, periodic in x
   and z, and periodic (all fluid), two pairs.  Then each at 256^3 on CUDA
   events (20 launches; plain: one call) beside P1: B4 float64 on the
   bench duct A-B, B2, B3 and B1 float64 on the bench duct A-A, B4's
   profile instances on sim_2 --velocity res 8 in turns with the vector
   instance on the same map and state; bound at 465 B/site (float64) or
   233 B plus the profile's bytes (float32), and in FP64-pipe slots.  Then
   sim_2 res 2 ``--precision double`` to t = 50 s per step, in pairs,
   under "auto" (its pick and probe times) and A-B: L1 within 5% of the
   start-up solution at the same iteration, printed beside the float32
   runs' L1 there; sim_2 ``--velocity`` res 4 (128^3), 100 steps through
   ``Simulation._advance`` against the plain step on the card (1e-5 in
   float32, 1e-10 in float64), and res 8 (256^3), 200 steps in float32 and
   float64 with MLUPS.  The six record entries' launches are these runs'.

12. sharded (last): the sharded lattice on one card, its plans putting N
   shards on N x ``cuda:0`` (``parallel/sharded.py``): each haloed mode
   against its plain version on every shard's block at the step bounds
   (float64 at 1e-12) - B4 float32 on sim_2 res 8's map on 2 y-shards
   (CUM_WELL) and on sim_1's and sim_3's res-2 maps on 2 x 2 (CUM with
   eq_inv_cum, eq_quadratic), B4 float64 (sim_2 res 8), B3's lean instance
   (sim_2 res 8) and its full set (sim_1 res 2 on 2 x 2); the three haloed
   kernels timed at sim_2 res 8's shard block (32 x 128 x 256, 20 launches;
   plain: 3 calls) with their bound (the haloed block read, the block
   written, the map and rho and u, or the FP32/FP64 slots of every thread);
   then N shards against one, 100 steps through ``Simulation`` from rest:
   sim_2 res 8 A-B unsharded, on 1, on choose_plan's 2 and 4, and on its
   uneven 3; A-A per step on 1 and 2; sim_1 res 4 A-A on 1 and 2 x 2 - the
   N-shard f, rho and u bit for bit the one-shard run's (or the difference
   printed and within the step bounds), each run's ms per step, MLUPS, peak
   memory and halo exchange on CUDA events; where the machine has more than
   one card, sim_2 res 8 over them too; then the apps through their
   ``main`` with ``--sharded`` over the machine's cards: sim_2 res 2 A-B to
   t = 10 s, its L1 within 5% of the start-up solution and equal to the
   unsharded A-B run's (run to the same time) at its last probe, sim_2 res 2
   ``--scaling weak_1d`` and ``weak_3d``, ``--precision double`` and
   ``--streaming AA``, sim_1 res 2 A-B and ``--streaming AA``, sim_3 res 2,
   each through the haloed kernels with no plain call.  The three record
   entries' launches are these runs'.

The line before the last is the kernels' JSON record (bound_ms: the larger
of the bytes over the published 3.35 TB/s and the FP32 instructions over
the card's issue rate, one FP32-pipe slot each at 128 lanes an SM (MUFU
one SFU slot at 16), from its SM count and maximum SM clock, at 256^3
sites; B5's launches: the three 2D apps' kernel runs
and the res-64 run and the golden sweep's; B5's resident chunk at the
golden sweep's 128 x 32, 20 steps a launch (its bound: the bytes once or
the FP32 operations its map's sites execute 20 times, whichever is
larger), its launches the golden row run through it, with its ms per
step, sync floor and cluster; B1b's: the bench entry's; B4s's and
the probes': their timings'; library_ms: P4's function as one PyTorch
call, ``interior(fpad).contiguous()``, and null where no single PyTorch
call computes a kernel's function; B1b's entry also gives the pair's
time, ``pair_ms``, its least-work bound, ``pair_bound_ms`` (233 B/site),
B1 f32 timed in turns with it, each instance's registers and spills and
its sim_1 res 8 time beside B2 + B3; B1's entries also give its
registers, shared memory and stages; the ab_step, aa_even and aa_odd
entries list the collisions' instances: id, kernel, ms, the run's MLUPS,
registers, spill bytes, max |df| and bound; their launches add the
collisions' runs; the force_field, nn_step and aa_pair_full entries
list the family instances of collision_routes the same way, and their
launches add its runs);
the last line is ``{"ok": true, "device": {...}}``.  The
script's total time, the library's cold build and each phase's seconds
are logged before them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
NU, FORCE_SMALL, FORCE_BENCH = 0.02, 1e-5, 1e-6
TOL_F, TOL_RHO, TOL_U = 1e-6, 2e-6, 1e-6
L1_JAX_RECORDED = 1.074e-4  # docs/PERFORMANCE.md:58, a transient reading
BENCH_SHAPE = (256, 256, 256)
BENCH_STEPS = 200
HBM_PEAK_GBPS = 3350.0  # H100 SXM data sheet
STORES = ("f32", "f16", "bf16")
PAIR_BYTES = {"f32": 233, "f16": 125, "bf16": 125}  # B/site per pair (f in + out, map, rho/u)
AB_BYTES = 233  # B/site per A-B step: 27 f32 in and out, the map, rho and u
SITEMAJOR_BYTES = 253  # B4s: 27 f32 in, 32 out (the zero dummies), the map, rho and u
SIM1_RES, APP_STEPS, TOL_APP = 8, 100, 1e-5
SIM1_AA_PLAIN_RES = 4  # sim_1 A-A kernel vs plain: the plain step's temporaries at res 8 exceed the card
#: lanes per SM of the FP32 pipe (every FADD, FMUL, FFMA or FMNMX one issue slot
#: of a lane) and of the SFU (MUFU) on an H100; the card's SM count and
#: maximum SM clock give the rates (``card_rates``)
FP32_LANES, SFU_LANES = 128, 16
#: lanes per SM of the FP64 pipe (every DFMA, DADD or DMUL one issue slot):
#: half the FP32 pipe's, 34 TFLOP/s outside the tensor cores at 132 SMs
FP64_LANES = 64
#: SASS opcodes that take one FP32-pipe slot, the SFU's, and the FP64 pipe's
FP32_PIPE_OPS = frozenset({"FADD", "FADD32I", "FMUL", "FMUL32I", "FFMA", "FFMA32I", "FMNMX",
                           "FMNMX32I"})
SFU_OPS = frozenset({"MUFU"})
FP64_PIPE_OPS = frozenset({"DFMA", "DADD", "DMUL"})
#: the card's issue rates (``card_rates``), set by ``phase_device``
RATES: dict = {}
TOL_G, TOL_PHI = 1e-6, 2e-6
NU_ADE = 0.02  # the ADE timing's diffusion
ADE_BYTES, COUPLED_BYTES, TWO_KERNEL_BYTES = 73, 294, 306  # B/site: B6, B7, B4 then B6
COUPLED_RES = 8
#: the y band of sim_coupled that the WALL_BODY walls cannot reach in APP_STEPS steps
WALL_REACH = APP_STEPS
PROBE_PASSES = (0, 20, 60)
#: the P3 variant and the P4 window of the JSON record: 20 passes as P2's,
#: and the script's status-quo window (y_off 0, ty + 16 rows, dst_off 0)
ELEMENT_TIMED, WINDOW_TIMED = (8, 32, 20), (0, 48, 0)
DEVICE = "cuda"
#: the D2Q9 step (B5): 9 f32 in and out, the map, rho and u (B/site); the
#: thetas and the profile are added per run, at the sites that read them
B5_BYTES = 85
#: FP32 operations of one B5 site update by the site's class, counted from
#: csrc/d2q9_step.cu ``update`` as written: an add, a multiply, a divide or
#: an fmaxf is one, a negation or a select none, an expression of constants
#: none (the compiler folds it).  Every site but NOTHING takes the moments
#: (rho, j, u: 26); a FLUID_NEAR_WALL site with thetas the Bouzidi
#: interpolation (8 links of 11); INFLOW and OUTFLOW_EQ the boundary
#: equilibrium (66); FLUID, OUTFLOW_RIGHT and FLUID_NEAR_WALL the collision
#: (CLBM: 6 forward axes of 10, the relaxation 10, 6 backward axes of 12;
#: SRT 102, Guo's term 78 more).  What a site executes, not the SASS
#: listing's every branch.
B5_MOMENT_OPS, B5_RING_OPS, B5_EQ_OPS = 26, 8 * 11, 66
B5_COLLISION_OPS = {"clbm": 6 * 10 + 10 + 6 * 12, "srt": 102, "srt_force": 102 + 78}
D2Q9_KERNEL_NAMES = ("d2q9_srt_kernel", "d2q9_srt_force_kernel", "d2q9_clbm_kernel",
                     "d2q9_chunk_srt_kernel", "d2q9_chunk_srt_force_kernel",
                     "d2q9_chunk_clbm_kernel")
#: sim2d_3's channel at resolution 64: 8192 x 2048, the site count of 256^3
TIME_2D_RES = 64
#: the rows of the golden corpus that the JAX suite samples
#: (tests/test_geometry_pipeline.py:138-143), (geometry, Bouzidi)
GOLDEN_SAMPLED = ((1, True), (4, True), (4, False), (6, True), (9, False), (14, True),
                  (18, False), (23, True), (29, False), (33, True), (41, True), (54, False))
TOL_GOLDEN = 1e-4  # relative (tests/test_geometry_pipeline.py:151-154)
GOLDEN_STEPS = 1440  # resolution 1 to the corpus' final time 0.4
#: sim2d_3's dispatch chunk: one launch of B5's resident chunk at 128 x 32
GOLDEN_CHUNK = 20
#: the golden row's 20-step chunks replayed from a graph: all but the eager
#: warm-up and the captured one
GOLDEN_REPLAYS = GOLDEN_STEPS // GOLDEN_CHUNK - 2
#: variants of the resident chunk (tests/b5_chunk_ablation.py) timed beside
#: it at 128 x 32: its sync floor and the smaller clusters
B5_VARIANTS = ("sync_floor", "cluster_8", "cluster_4")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def store_dtype(store: str):
    import torch

    return {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}[store]


def rand_f(cfg, shape, device, seed=0):
    """Seeded near-equilibrium state (tests/test_fused_kernel.py:25-29)."""
    import torch

    rng = np.random.default_rng(seed)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    return cfg.eq(cfg.lat, rho.to(device), u.to(device)).float().contiguous()


#: rand_f's (rho, u) at 256^3 per seed, kept on the card: the collision
#: phases take many configs' equilibria of the same developed state
_DEVELOPED: dict = {}


def developed_f(cfg, seed=1):
    """``rand_f(cfg, BENCH_SHAPE, DEVICE, seed)`` bit for bit, its seeded
    rho and u drawn once per seed."""
    import torch

    if seed not in _DEVELOPED:
        rng = np.random.default_rng(seed)
        rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(BENCH_SHAPE)).astype(np.float32))
        u = torch.from_numpy((0.02 * rng.standard_normal((3,) + BENCH_SHAPE)).astype(np.float32))
        _DEVELOPED[seed] = (rho.to(DEVICE), u.to(DEVICE))
    rho, u = _DEVELOPED[seed]
    return cfg.eq(cfg.lat, rho, u).float().contiguous()


def flagship(shape, storage=None, streaming="AA"):
    """The bench duct of the port's benchmark entry (``bench.flagship``:
    walls on the y and z faces, periodic in x, lattice viscosity NU), with
    ``streaming`` and, for "f16" / "bf16", half storage."""
    from tnl_lbm_tpu_torch import bench

    cfg, dom = bench.flagship(shape)
    cfg = dataclasses.replace(cfg, streaming=streaming)
    if storage not in (None, "f32"):
        cfg = dataclasses.replace(cfg, storage_dtype=store_dtype(storage))
    return cfg, dom


def max_diff(a, b) -> float:
    """max |a - b| in float64; a [Q or 3, X, Y, Z] field one component at a
    time, so that no whole-state float64 temporary is made."""
    if a.ndim == 4:
        return max(max_diff(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def read_vti(path) -> dict:
    """name -> float32 array [X, Y, Z] (scalars) or [3, X, Y, Z] (vectors)
    of a .vti written by ``io.vtk.write_vti`` (appended raw, uint64 sizes)."""
    import re

    raw = Path(path).read_bytes()
    head, body = raw.split(b"<AppendedData encoding=\"raw\">", 1)
    body = body[body.index(b"_") + 1 :]
    x0, x1, y0, y1, z0, z1 = map(int, re.search(rb'WholeExtent="([^"]+)"', head).group(1).split())
    shape = (z1 - z0 + 1, y1 - y0 + 1, x1 - x0 + 1)
    out = {}
    for name, comps, offset in re.findall(
            rb'Name="(\w+)" NumberOfComponents="(\d)" format="appended" offset="(\d+)"', head):
        n = int(np.frombuffer(body, "<u8", 1, int(offset))[0])
        a = np.frombuffer(body, "<f4", n // 4, int(offset) + 8)
        if int(comps) == 1:
            out[name.decode()] = a.reshape(shape).transpose(2, 1, 0)
        else:
            out[name.decode()] = a.reshape(shape + (3,)).transpose(3, 2, 1, 0)
    return out


def narrowing_exact(cfg, dom, f, fk, rk, uk, force) -> bool:
    """The 16-bit pair kernel's output (fk, rk, uk) on f equals the float32
    kernel's on the widened f, with the state narrowed: widening is exact,
    so the two instances differ only in the narrowing."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_aa import from_storage, make_fused_pair2_aa, to_storage

    if f.dtype == torch.float32:
        return True
    fw, rw, uw = make_fused_pair2_aa(cfg, dom, f.device)(from_storage(f, torch.float32), NU,
                                                         force=force)
    return (torch.equal(to_storage(fw, f.dtype), fk) and torch.equal(rw, rk)
            and torch.equal(uw, uk))


def share_differing(a, b) -> float:
    return float((a != b).double().mean())


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gbps(bytes_per_site: float, ms: float) -> float:
    return bytes_per_site * float(np.prod(BENCH_SHAPE)) / (ms * 1e-3) / 1e9


def card_rates(sms: int, max_sm_mhz: float) -> dict:
    """FP32-pipe, SFU and FP64-pipe issue slots per second of a card with
    ``sms`` SMs at ``max_sm_mhz``: FP32_LANES, SFU_LANES and FP64_LANES
    lanes per SM and clock."""
    hz = max_sm_mhz * 1e6
    return {"sms": sms, "max_sm_mhz": max_sm_mhz, "fp32_per_s": sms * FP32_LANES * hz,
            "sfu_per_s": sms * SFU_LANES * hz, "fp64_per_s": sms * FP64_LANES * hz}


def ops_ms(fp32: float, mufu: float, rates: dict, fp64: float = 0.0) -> float:
    """The least time in ms for ``fp32`` FP32-pipe, ``mufu`` SFU and ``fp64``
    FP64-pipe instructions (counted per lane): each pipe's count over its
    rate, the slowest pipe's."""
    return max(fp32 / rates["fp32_per_s"], mufu / rates["sfu_per_s"],
               fp64 / rates["fp64_per_s"]) * 1e3


def phase_device() -> dict:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0])
    RATES.update(card_rates(torch.cuda.get_device_properties(0).multi_processor_count, mhz))
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    log("device", name=repr(info["kind"]), count=info["count"], nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda, sms=RATES["sms"],
        max_sm_mhz=RATES["max_sm_mhz"], fp32_slots_per_s=f"{RATES['fp32_per_s']:.4e}",
        sfu_slots_per_s=f"{RATES['sfu_per_s']:.4e}",
        fp64_slots_per_s=f"{RATES['fp64_per_s']:.4e}")
    return info


ADE_KERNEL_NAMES = tuple(f"ade_step_{c}_kernel" for c in ("srt", "mrt", "clbm", "clbm_rs"))
NSE_VARIANTS = ("cum_well", "cum_quad", "cum_invcum")
COUPLED_KERNEL_NAMES = tuple(f"coupled_{n}_{c}_kernel" for n in NSE_VARIANTS
                             for c in ("srt", "mrt", "clbm", "clbm_rs"))
AA_KERNEL_NAMES = tuple(f"aa_{p}_{n}_kernel" for p in ("even", "odd") for n in NSE_VARIANTS)
COUPLED_AA_KERNEL_NAMES = tuple(f"coupled_aa_{p}_{n}_{c}_kernel" for p in ("even", "odd")
                                for n in NSE_VARIANTS for c in ("srt", "mrt", "clbm", "clbm_rs"))
#: B1b's instances: the full set per variant and the lean one
FULL_PAIR_KERNEL_NAMES = (tuple(f"aa_pair_full_{n}_kernel" for n in NSE_VARIANTS)
                          + ("aa_pair_full_lean_kernel",))
LAYOUT_KERNEL_NAMES = (FULL_PAIR_KERNEL_NAMES
                       + tuple(f"ab_step_sitemajor_{n}_kernel" for n in NSE_VARIANTS))
PIPELINE_KERNEL_NAMES = tuple(f"pair_pipeline_{load}_kernel"
                              for load in ("stages", "direct", "ring"))
WINDOW_KERNEL_NAMES = tuple(f"window_copy_{load}_kernel" for load in ("ld4", "ld16", "tma"))
#: the instance tags of the family sources (csrc/coll_*.cu COLL_KERNELS): the KBC
#: variants share one instance per kernel, chosen at run time
COLLISION_TAGS = ("srt", "srt_well", "srt_modif_force", "bgk", "bgk_well", "mrt_les", "clbm",
                  "clbm_well", "kbc")
COLLISION_KERNEL_NAMES = tuple(f"{p}_{t}_kernel" for t in COLLISION_TAGS
                               for p in ("ab_step", "aa_even", "aa_odd"))
#: the per-step kernels' record entries and their pattern's prefix in the instance names
COLLISION_KERNELS = {"ab_step": "ab_step", "aa_even": "aa_even", "aa_odd": "aa_odd"}
COLLISION_STEPS = 100  # steps of each collision's runs on the bench duct
COLLISION_BOX = (24, 20, 150)  # the box of every code of the compares (Z past one block)


def collision_tag(cid: str) -> str:
    return "kbc" if cid.startswith("KBC") else cid.lower()


def count_sass_ops(sass: str, subroutines: bool = True) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing: (FP32-pipe instructions,
    SFU instructions, FP64-pipe instructions) per thread.  Every FADD, FMUL,
    FFMA and FMNMX, their immediate forms too, is one slot of the FP32
    pipe, whatever it computes; every MUFU one of the SFU; every DFMA, DADD
    and DMUL one of the FP64 pipe.  Every branch counts once, so for a
    kernel without loops this bounds what one site issues from above.
    Without ``subroutines``, the code from the first target of the
    kernel's CALLs on is left out: the slow paths of the IEEE divisions and
    square roots, placed after the kernel's body, which only zero,
    denormal, infinite or NaN operands take."""
    import re

    ops, current = {}, None
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)\S*\s*(.*)")
    funcs: dict = {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = m.group(1)
            funcs[current] = []
            continue
        if current is None:
            continue
        m = instr.search(line)
        if m:
            funcs[current].append((int(m.group(1), 16), m.group(2), m.group(3)))
            continue
        m = re.match(r"\s*([$.\w]+):\s*$", line)
        if m:  # a label, as nvdisasm-style listings give them
            funcs[current].append((None, m.group(1), ""))
    for name, body in funcs.items():
        ops[name] = [0, 0, 0]
        end = None
        if not subroutines:
            targets = set()
            for _, op, rest in body:
                if op == "CALL":
                    t = re.search(r"0x([0-9a-f]+)|`?\(?([$.\w]+)\)?", rest)
                    targets.add(int(t.group(1), 16) if t.group(1) else t.group(2))
            starts = [i for i, (addr, op, _) in enumerate(body)
                      if (addr is not None and addr in targets)
                      or (addr is None and op in targets)]
            end = min(starts) if starts else None
        for addr, op, _ in body[:end]:
            if addr is None:
                continue
            ops[name][0] += op in FP32_PIPE_OPS
            ops[name][1] += op in SFU_OPS
            ops[name][2] += op in FP64_PIPE_OPS
    return {k: tuple(v) for k, v in ops.items()}


def sass_fp32_ops(lib_path, names=None) -> dict:
    """``count_sass_ops`` of the built library: of the kernels ``names``
    (``cuobjdump -fun``) where given and the listing holds them all, else of
    every kernel."""
    import os

    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    if names:
        some = subprocess.run([exe, "-sass", "-fun", ",".join(names), str(lib_path)],
                              capture_output=True, text=True)
        ops = count_sass_ops(some.stdout) if some.returncode == 0 else {}
        if all(n in ops for n in names):
            return ops
    return count_sass_ops(subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                                         text=True, check=True).stdout)


#: the kernels whose registers and spills the build phases log, and (but
#: ROUTE_KERNEL_NAMES, whose bounds take ``site_ops``) their SASS counts
def build_kernel_names() -> tuple:
    return sass_kernel_names() + ROUTE_KERNEL_NAMES


def sass_kernel_names() -> tuple:
    return (("aa_odd_kernel", "aa_pair_f32_kernel", "aa_pair_f16_kernel",
             "aa_pair_bf16_kernel", "ab_step_cum_well_kernel", "ab_step_cum_quad_kernel",
             "ab_step_cum_invcum_kernel", "copy_permute_kernel", "pair_compute_only_kernel",
             "element_pipeline_kernel") + PIPELINE_KERNEL_NAMES + LAYOUT_KERNEL_NAMES
            + WINDOW_KERNEL_NAMES + AA_KERNEL_NAMES + ADE_KERNEL_NAMES
            + COUPLED_KERNEL_NAMES + COUPLED_AA_KERNEL_NAMES + D2Q9_KERNEL_NAMES
            + NN_KERNEL_NAMES + COLLISION_KERNEL_NAMES)


def phase_build() -> dict:
    """Build the kernels (the library's cold build; registers, spills and
    shared memory per kernel from ptxas) and beside them B5_VARIANTS of the
    resident chunk (tests/b5_chunk_ablation.py) and a fluid site's work under
    each collision of the family kernels (tests/collision_site_ops.py), one
    nvcc each, started first; then start the library's SASS count of the
    kernels ``sass_kernel_names`` (``sass_fp32_ops`` in a subprocess), which
    ``phase_build_rest`` collects with the rest, beside the next phases."""
    import b5_chunk_ablation as ablation
    import collision_site_ops

    from tnl_lbm_tpu_torch.kernels.build import build_library, kernel_resources, load_library
    from tnl_lbm_tpu_torch.kernels.fused_nn import nn_geometry

    t0 = time.perf_counter()
    later = {"variants": ablation.start(WORK / "b5_variants", B5_VARIANTS),
             "site": collision_site_ops.start(WORK / "site_ops")}
    path, ptxas = build_library()
    seconds = time.perf_counter() - t0
    later["sass"] = subprocess.Popen(
        [sys.executable, "-c", "import json, sys; import chip_smoke as cs; print(json.dumps("
         "cs.sass_fp32_ops(sys.argv[1], cs.sass_kernel_names())))", str(path)],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)
    lib = load_library()
    res = kernel_resources(ptxas)
    for name in build_kernel_names():
        if name not in res:
            raise RuntimeError(f"no ptxas report for {name}:\n{ptxas}")
        log("build", kernel=name, **res[name])
    nn_geo = {key: nn_geometry(kind, BENCH_SHAPE) for kind, key in ((0, "nn_force"),
                                                                     (1, "nn_step"))}
    log("build", library_seconds=f"{seconds:.1f}",
        pair_dynamic_smem_bytes=lib.tnl_lbm_aa_pair_smem_bytes(),
        **{f"{key}_geometry_256": json.dumps(g) for key, g in nn_geo.items()})
    return {"res": res, "nn_geometry": nn_geo, "later": later, "seconds": seconds}


def phase_build_rest(built: dict) -> None:
    """Wait for what ``phase_build`` started and add it to ``built``: the B5
    variants ("b5_variants"), the FP32 operations per thread of every kernel
    from the library's SASS ("ops") and a fluid site's under each collision
    without the IEEE slow paths ("site_ops")."""
    import b5_chunk_ablation as ablation
    import collision_site_ops

    later = built.pop("later")
    variants = ablation.finish(later["variants"])
    site_sass = collision_site_ops.finish(later["site"])
    out, _ = later["sass"].communicate()
    if later["sass"].returncode != 0:
        raise RuntimeError("the library's SASS count failed")
    ops = {k: tuple(v) for k, v in json.loads(out.strip().splitlines()[-1]).items()}
    site_ops, site_all = count_sass_ops(site_sass, subroutines=False), count_sass_ops(site_sass)
    site_ops = {cid: site_ops[collision_site_ops.kernel_name(cid)]
                for cid in collision_site_ops.COLLISION_INSTANCES}
    for cid, (fp32, sfu, _) in site_ops.items():
        whole = site_all[collision_site_ops.kernel_name(cid)]
        log("build", fluid_site=cid, fp32_slots=fp32, mufu=sfu, fp32_slots_with_slow_paths=whole[0],
            mufu_with_slow_paths=whole[1])
    for name in sass_kernel_names():
        if name not in ops:
            raise RuntimeError(f"no SASS for {name}")
        log("build", kernel=name, fp32_slots_per_thread=ops[name][0], mufu_per_thread=ops[name][1])
    built.update(ops=ops, site_ops=site_ops, b5_variants=variants)


def phase_compare_steps() -> dict:
    """Even/odd kernels vs their plain versions; per-kernel max |df| and
    times at 256^3."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

    dev = torch.device(DEVICE)
    sim = sim_2.build(2, device=dev, streaming="AA", use_fused=True,
                      results_parent=WORK / "compare")
    cfg, dom = sim.cfg, sim.domain
    step = make_fused_step_aa(cfg, dom, dev)
    force = (FORCE_SMALL, 0.0, 0.0)
    err = {"aa_even": 0.0, "aa_odd": 0.0}
    worst = [0.0, 0.0, 0.0]
    fk = rand_f(cfg, dom.shape, dev, seed=5)
    fp = fk.clone()
    for it in range(4):
        parity = it % 2
        fk, rk, uk = step(fk, NU, force=force, parity=parity)
        fp, rp, up = step.plain(fp, NU, force=force, parity=parity)
        torch.cuda.synchronize()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        worst = [max(a, b) for a, b in zip(worst, d)]
        name = ("aa_even", "aa_odd")[parity]
        err[name] = max(err[name], d[0])
    log("compare", shape="x".join(map(str, dom.shape)), steps=4, max_df=worst[0],
        max_drho=worst[1], max_du=worst[2], launches_even=step.even.launches,
        launches_odd=step.odd.launches)
    if not (worst[0] <= TOL_F and worst[1] <= TOL_RHO and worst[2] <= TOL_U):
        raise RuntimeError(f"kernel vs plain out of tolerance: {worst}")

    # one step of each kernel against its plain version at the bench shape;
    # the odd step's lean CUM_WELL instance is timed beside the full-set one
    cfg, dom = flagship(BENCH_SHAPE)
    step, full = make_fused_step_aa(cfg, dom, dev), make_fused_step_aa(cfg, dom, dev, lean=False)
    bench_force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    times = {}
    for parity, name in ((0, "aa_even"), (1, "aa_odd")):
        fk, rk, uk = step(f0.clone(), NU, force=bench_force, parity=parity)
        fp, rp, up = step.plain(f0, NU, force=bench_force, parity=parity)
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        del fk, rk, uk, fp, rp, up
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"{name} kernel vs plain at 256^3 out of tolerance: {d}")
        err[name] = max(err[name], d[0])
        fw = f0.clone()
        ms = time_ms(lambda: step(fw, NU, force=bench_force, parity=parity), reps=20)
        lean = {}
        if parity == 1:  # the odd step's lean instance beside its full CUM_WELL one
            lean["full_cum_well_instance_ms"] = "%.4f" % time_ms(
                lambda: full(fw, NU, force=bench_force, parity=parity), reps=20)
        plain_ms = time_ms(lambda: step.plain(f0, NU, force=bench_force, parity=parity), reps=3)
        del fw
        torch.cuda.empty_cache()
        times[name] = (ms, plain_ms)
        log("compare", kernel=name, shape="256^3", variant=step.variant, max_df=d[0],
            max_drho=d[1], max_du=d[2], ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
            gbps_216B=f"{gbps(216, ms):.1f}", **lean)
    return {"err": err, "times": times}


def phase_compare_aa_codes() -> float:
    """The even/odd kernels on a box of every A-A code with a Z that the
    block's 128 z sites do not divide, per variant (CUM_WELL; CUM with
    eq_quadratic; CUM with eq_inv_cum): 4 alternating steps, each kernel
    step against the plain version on the same input.  Returns max |df|."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
    from torch_cases import AB_SPECS, U_IN, aa_box

    dev = torch.device(DEVICE)
    dom = interop.domain_from_numpy(aa_box((24, 20, 150)), (False, False, True))
    force = (FORCE_SMALL, 0.0, 0.0)
    worst_f = 0.0
    for spec in AB_SPECS.values():
        cfg = interop.config_from_spec(*spec, "AA")
        step = make_fused_step_aa(cfg, dom, dev)
        f = rand_f(cfg, dom.shape, dev, seed=11)
        worst = [0.0, 0.0, 0.0]
        for it in range(4):
            fp, rp, up = step.plain(f, NU, u_in=U_IN, force=force, parity=it % 2)
            f, rk, uk = step(f.clone(), NU, u_in=U_IN, force=force, parity=it % 2)
            torch.cuda.synchronize()
            worst = [max(a, b) for a, b in zip(worst, (max_diff(f, fp), max_diff(rk, rp),
                                                       max_diff(uk, up)))]
        log("compare_aa_codes", variant=f"{spec[0]}/{spec[1]}", shape="x".join(map(str, dom.shape)),
            codes="+".join(sorted(c.name for c in step.codes)), steps=4, max_df=worst[0],
            max_drho=worst[1], max_du=worst[2], launches_even=step.even.launches,
            launches_odd=step.odd.launches)
        if not (worst[0] <= TOL_F and worst[1] <= TOL_RHO and worst[2] <= TOL_U):
            raise RuntimeError(f"A-A kernels vs plain on the every-code box, {spec}: {worst}")
        worst_f = max(worst_f, worst[0])
    return worst_f


def phase_compare_pairs(step_times: dict) -> dict:
    """The pair kernel vs its plain version per store dtype, at res 2 and
    at 256^3; timed beside one even plus one odd launch."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa, to_storage
    from tnl_lbm_tpu_torch.utils.dtypes import state_agrees

    dev = torch.device(DEVICE)
    two_steps_ms = step_times["aa_even"][0] + step_times["aa_odd"][0]
    err, times, geometry = {}, {}, {}
    for store in STORES:
        dtype = store_dtype(store)
        name = f"aa_pair_{store}"
        sim = sim_2.build(2, device=dev, streaming="AA", use_fused=True,
                          results_parent=WORK / "compare" / store)
        pair = make_fused_pair2_aa(sim.cfg, sim.domain, dev, store_dtype=dtype)
        force = (FORCE_SMALL, 0.0, 0.0)
        f = to_storage(rand_f(sim.cfg, sim.domain.shape, dev, seed=5), dtype)
        worst = [0.0, 0.0, 0.0, 0.0]
        for it in range(2):
            fk, rk, uk = pair(f, NU, force=force)
            fp, rp, up = pair.plain(f, NU, force=force)
            torch.cuda.synchronize()
            d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up), share_differing(fk, fp))
            worst = [max(a, b) for a, b in zip(worst, d)]
            if not (state_agrees(fk, fp, dtype) and d[1] <= TOL_RHO and d[2] <= TOL_U):
                raise RuntimeError(f"{name} vs plain on the res-2 duct, pair {it}: {d}")
            if not narrowing_exact(sim.cfg, sim.domain, f, fk, rk, uk, force):
                raise RuntimeError(f"{name} on the res-2 duct, pair {it}: not the float32 "
                                   f"kernel's output narrowed to nearest even")
            f = fk
        log("compare", kernel=name, shape="x".join(map(str, sim.domain.shape)), pairs=2,
            max_df=worst[0], max_drho=worst[1], max_du=worst[2], share_f_differing=worst[3],
            narrowing_exact=True, launches=pair.kernel.launches, geometry=pair.geometry())
        err[name] = max(worst[0], pair_boxes(store))

        cfg, dom = flagship(BENCH_SHAPE)
        pair = make_fused_pair2_aa(cfg, dom, dev, store_dtype=dtype)
        bench_force = (FORCE_BENCH, 0.0, 0.0)
        f0 = to_storage(rand_f(cfg, dom.shape, dev, seed=7), dtype)
        fk, rk, uk = pair(f0, NU, force=bench_force)
        fp, rp, up = pair.plain(f0, NU, force=bench_force)
        ok = state_agrees(fk, fp, dtype)
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up), share_differing(fk, fp))
        del fp, rp, up
        torch.cuda.empty_cache()
        if not (ok and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"{name} vs plain at 256^3 out of tolerance: {d}")
        if not narrowing_exact(cfg, dom, f0, fk, rk, uk, bench_force):
            raise RuntimeError(f"{name} at 256^3: not the float32 kernel's output narrowed "
                               f"to nearest even")
        del fk, rk, uk
        torch.cuda.empty_cache()
        err[name] = max(err[name], d[0])
        out = torch.empty_like(f0)
        ms = time_ms(lambda: pair(f0, NU, force=bench_force, out=out), reps=20)
        plain_ms = time_ms(lambda: pair.plain(f0, NU, force=bench_force), reps=3)
        del f0, out
        torch.cuda.empty_cache()
        times[name] = (ms, plain_ms)
        geometry[name] = pair.geometry()
        log("compare", kernel=name, shape="256^3", geometry=geometry[name],
            max_df=d[0], max_drho=d[1], max_du=d[2],
            share_f_differing=d[3], narrowing_exact=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", even_plus_odd_ms=f"{two_steps_ms:.4f}",
            pair_over_two_launches=f"{ms / two_steps_ms:.3f}",
            **{f"gbps_{PAIR_BYTES[store]}B": f"{gbps(PAIR_BYTES[store], ms):.1f}"})
    return {"err": err, "times": times, "geometry": geometry}


#: boxes of the pair compare (tests/test_torch_gpu.py): (shape, periodic, NOTHING
#: sites, x segment); none divided by a column tile, the first two by no
#: segment of 7, the third shorter than its segment, the fourth with a z
#: extent of no whole 16-byte pieces (read without staging)
PAIR_BOXES = tuple(((20, 36, 40), per, True, seg)
                   for per in ((True, False, False), (False, False, False), (True, True, True))
                   for seg in (None, 7)) + (((5, 13, 48), (True, False, True), True, 8),
                                            ((9, 11, 45), (True, False, True), True, None))


def pair_boxes(store: str) -> float:
    """Two pairs on each of PAIR_BOXES, kernel against plain and, in 16 bits,
    against the float32 kernel narrowed; returns the largest |df|."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa, to_storage
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from tnl_lbm_tpu_torch.utils.dtypes import state_agrees

    dev, dtype, worst = torch.device(DEVICE), store_dtype(store), 0.0
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    for shape, periodic, nothing, seg in PAIR_BOXES:
        m = np.zeros(shape, np.uint8)
        if periodic != (True, True, True):
            m[:, 0] = m[:, -1] = GEO.WALL
            m[:, :, 0] = m[:, :, -1] = GEO.WALL
        if nothing:
            m[shape[0] // 2, 3, 4] = GEO.NOTHING
        dom = interop.domain_from_numpy(m, periodic)
        pair = make_fused_pair2_aa(cfg, dom, dev, store_dtype=dtype, seg_len=seg)
        f = to_storage(rand_f(cfg, shape, dev, seed=9), dtype)
        for it in range(2):
            fk, rk, uk = pair(f, NU, force=(FORCE_SMALL, 0.0, 0.0))
            fp, rp, up = pair.plain(f, NU, force=(FORCE_SMALL, 0.0, 0.0))
            d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
            if not (state_agrees(fk, fp, dtype) and d[1] <= TOL_RHO and d[2] <= TOL_U
                    and narrowing_exact(cfg, dom, f, fk, rk, uk, (FORCE_SMALL, 0.0, 0.0))):
                raise RuntimeError(f"aa_pair_{store} on the box {shape} {periodic} (segments "
                                   f"{seg}), pair {it}: {d}")
            worst = max(worst, d[0])
            f = fk
    log("compare", kernel=f"aa_pair_{store}", boxes=len(PAIR_BOXES), pairs=2, max_df=worst)
    return worst


def compute_only_bytes() -> float:
    """P2b's bytes per site at BENCH_SHAPE: its first item read once and
    written once, over the lattice's sites."""
    from tnl_lbm_tpu_torch.kernels.probes import first_block

    return 27 * 4 * 2 * float(np.prod(first_block(BENCH_SHAPE))) / float(np.prod(BENCH_SHAPE))


def phase_probes(b1_ms: float, ops: dict) -> dict:
    """P1-P4 at 256^3 against their plain versions (P2a through each load
    path, P4's uncovering window must raise), then timed with the launch
    counts set to 0 just before; P2a's paths beside P1 and B1 f32's
    ``b1_ms`` of the same call, P2b beside its FP32-slot bound and its
    SASS count (``ops``: phase_build's)."""
    import torch

    from tnl_lbm_tpu_torch.kernels import probes
    from torch_cases import march_constants

    dev = torch.device(DEVICE)
    march = march_constants()
    f = torch.randn((27,) + BENCH_SHAPE, device=dev, generator=torch.Generator(dev).manual_seed(3))
    err = {}
    got, want = probes.copy_permute(f), probes.copy_permute_plain(f)
    err["copy_permute"] = max(max_diff(g, w) for g, w in zip(got, want))
    del got, want
    for passes in PROBE_PASSES:
        want = probes.pair_pipeline_plain(f, passes)
        for load, (_, name) in probes.PIPELINE_LOADS.items():  # bit for bit
            if not torch.equal(probes.pair_pipeline(f, passes, load=load), want):
                raise RuntimeError(f"pair_pipeline ({load}, {passes} passes) is not its plain "
                                   f"version bit for bit")
            err[name] = 0.0
        del want
        d = max_diff(probes.pair_compute_only(f, passes), probes.pair_compute_only_plain(f, passes))
        err["pair_compute_only"] = max(err.get("pair_compute_only", 0.0), d)
    X, Y, Z = BENCH_SHAPE
    t_window = time.perf_counter()
    fpad = torch.randn((27, X + 4, Y + 16, Z), device=dev,
                       generator=torch.Generator(dev).manual_seed(4))
    for tx, ty, passes in probes.ELEMENT_VARIANTS:  # the interiors, bit for bit
        got = probes.element_pipeline(fpad, tx, ty, passes)
        want = probes.element_pipeline_plain(fpad, tx, ty, passes)
        if not torch.equal(probes.interior(got), probes.interior(want)):
            raise RuntimeError(f"element_pipeline ({tx}, {ty}, {passes}) is not its plain "
                               f"version's interior bit for bit")
        del got, want
    covering = [v for v in probes.DMA_VARIANTS if probes.window_covers(v[0], v[1], v[3])]
    for y_off, wy, label, dst_off in probes.DMA_VARIANTS:
        if (y_off, wy, label, dst_off) not in covering:
            try:
                probes.window_copy(fpad, y_off, wy, dst_off)
            except ValueError as exc:
                log("probes", window=repr(label), covers=False, raises=repr(str(exc)[:60]))
                continue
            raise RuntimeError(f"window_copy {label!r} does not cover its tile and did not raise")
        for load in probes.LOADS:
            if not torch.equal(probes.window_copy(fpad, y_off, wy, dst_off, load),
                               probes.window_copy_plain(fpad, y_off, wy, dst_off)):
                raise RuntimeError(f"window_copy {label!r} ({load}) is not the interior")
    for name in ("element_pipeline",) + tuple(name for _, name in probes.LOADS.values()):
        err[name] = 0.0  # bit-equal interiors, checked above
    t_window = time.perf_counter() - t_window
    torch.cuda.synchronize()
    log("probes", compare="kernel vs plain at 256^3", covering_windows=len(covering),
        **{f"max_abs_err_{k}": v for k, v in err.items()})
    if any(v != 0.0 for v in err.values()):
        raise RuntimeError(f"probe kernels disagree with their plain versions: {err}")

    probes.reset_counts()
    times = {}
    ms = time_ms(lambda: probes.copy_permute(f), reps=20)
    plain_ms = time_ms(lambda: probes.copy_permute_plain(f), reps=3)
    times["copy_permute"] = (ms, plain_ms)
    floor = gbps(232, ms)
    log("probes", kernel="copy_permute", shape="256^3", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        gbps_232B=f"{floor:.1f}", share_of_3350=f"{floor / HBM_PEAK_GBPS:.3f}")
    compute_only, pipeline, library = {}, {}, {}
    p2a_out = torch.empty_like(f)  # P2a at 0 passes as one PyTorch call: f copied

    def state_copy():
        return p2a_out.copy_(f)

    p2a_library = [time_ms(state_copy, reps=20)]
    for passes in PROBE_PASSES:
        plain_ms = time_ms(lambda: probes.pair_pipeline_plain(f, passes), reps=3)
        for load, (_, name) in probes.PIPELINE_LOADS.items():
            ms = time_ms(lambda: probes.pair_pipeline(f, passes, load=load), reps=20)
            pipeline[(load, passes)] = ms
            if passes == 20:
                times[name] = (ms, plain_ms)
        co_ms = time_ms(lambda: probes.pair_compute_only(f, passes), reps=20)
        co_plain_ms = time_ms(lambda: probes.pair_compute_only_plain(f, passes), reps=3)
        compute_only[passes] = co_ms
        if passes == 20:
            times["pair_compute_only"] = (co_ms, co_plain_ms)
        co_bound, co_by = bound(compute_only_bytes(), (2 * 27 * passes, 0))
        log("probes", kernel="pair_compute_only", passes=passes, ms=f"{co_ms:.4f}",
            plain_ms=f"{co_plain_ms:.3f}", pair_pipeline_plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{co_bound:.4f}", bound_by=co_by,
            share_of_bound=f"{co_bound / co_ms:.3f}", fp32_per_site=2 * 27 * passes)
    p2a_library.append(time_ms(state_copy, reps=20))
    del p2a_out
    for _, name in probes.PIPELINE_LOADS.values():
        library[name] = min(p2a_library)
    # the SASS holds the passes' 54 FP32 instructions a round in as many copies as the
    # unrolled loop and its remainder, on the first item's path and the slots' path
    co_sass = ops["pair_compute_only_kernel"][0]
    log("probes", kernel="pair_compute_only", shape="256^3",
        geometry=json.dumps(probes.compute_only_geometry(BENCH_SHAPE)),
        sass_fp32_per_thread=co_sass, bound_fp32_per_pass_and_site=2 * 27,
        sass_copies_of_a_pass=f"{co_sass / (2 * 27):.3f}",
        library_ms_p2a="/".join(f"{v:.4f}" for v in p2a_library))
    for load in probes.PIPELINE_LOADS:  # the march's load paths, the input to B1b and B1
        geo = probes.pipeline_geometry(BENCH_SHAPE, load)
        # window sites read per tile site: the y-z halo and the segment's two halo planes
        reads = (march["WSITES"] / march["TILE_SITES"]) * (geo["seg_len"] + 2) / geo["seg_len"]
        for passes in PROBE_PASSES:
            ms = pipeline[(load, passes)]
            log("probes", kernel="pair_pipeline", load=load, passes=passes, ms=f"{ms:.4f}",
                gbps_216B=f"{gbps(216, ms):.1f}",
                gbps_windows=f"{gbps(108 * (reads + 1), ms):.1f}",
                share_of_p1=f"{gbps(216, ms) / floor:.3f}",
                over_passes_0=f"{ms / pipeline[(load, 0)]:.3f}",
                b1_f32_ms=f"{b1_ms:.4f}", window_reads_per_site=f"{reads:.4f}",
                **({"geometry": json.dumps(geo)} if passes == 0 else {}))
    for load in probes.PIPELINE_LOADS:  # does P2a hide its passes under its copies?
        for passes in PROBE_PASSES[1:]:
            added = pipeline[(load, passes)] - pipeline[(load, 0)]
            log("probes", overlap=f"pair_pipeline {load}, {passes} passes",
                added_ms=f"{added:.4f}", compute_only_ms=f"{compute_only[passes]:.4f}",
                hidden_share=f"{1 - added / compute_only[passes]:.3f}")
    fastest = min(probes.PIPELINE_LOADS, key=lambda load: pipeline[(load, 20)])
    log("probes", kernel="pair_pipeline", fastest_at_20_passes=fastest,
        default=probes.PIPELINE_DEFAULT)
    del f
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    element = {}
    copy_out = torch.empty_like(fpad)  # P3 at 0 passes as one PyTorch call: the interior copied

    def interior_copy():
        return probes.interior(copy_out).copy_(probes.interior(fpad))

    for tx, ty, passes in probes.ELEMENT_VARIANTS:
        line = {"library_ms": time_ms(interior_copy, reps=20)} if passes == 0 else {}
        ms = time_ms(lambda: probes.element_pipeline(fpad, tx, ty, passes), reps=20)
        plain_ms = time_ms(lambda: probes.element_pipeline_plain(fpad, tx, ty, passes), reps=3)
        element[(tx, ty, passes)] = ms
        if (tx, ty, passes) == ELEMENT_TIMED:
            times["element_pipeline"] = (ms, plain_ms)
        if passes == 0:
            line["library_after_ms"] = time_ms(interior_copy, reps=20)
            library.setdefault("element_pipeline", min(line.values()))
            line["over_library"] = f"{ms / min(line.values()):.3f}"
        script_bytes = 27 * 4 * ((tx + 4) * (ty + 16) / (tx * ty) + 1)  # the script's GB count
        log("probes", kernel="element_pipeline", tile=f"{tx}x{ty}", passes=passes,
            **probes.element_geometry(tx, ty, X, Z), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            gbps_216B=f"{gbps(216, ms):.1f}", gbps_script=f"{gbps(script_bytes, ms):.1f}",
            **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in line.items()})
    del copy_out
    for passes in PROBE_PASSES[1:]:  # does P3 hide its passes under its copies?
        added = element[(8, 32, passes)] - element[(8, 32, 0)]
        log("probes", overlap=f"element_pipeline 8x32, {passes} passes",
            added_ms=f"{added:.4f}", compute_only_ms=f"{compute_only[passes]:.4f}",
            hidden_share=f"{1 - added / compute_only[passes]:.3f}")
    for y_off, wy, label, dst_off in covering:  # the call timed before and after the loads
        line = {"library_ms": time_ms(lambda: probes.interior(fpad).contiguous(), reps=20)}
        timed = (y_off, wy, dst_off) == WINDOW_TIMED
        for load, (_, name) in probes.LOADS.items():
            ms = time_ms(lambda: probes.window_copy(fpad, y_off, wy, dst_off, load), reps=20)
            line[f"{load}_ms"] = ms
            if timed:
                plain_ms = time_ms(lambda: probes.window_copy_plain(fpad, y_off, wy, dst_off),
                                   reps=3)
                times[name] = (ms, plain_ms)
        line["library_after_ms"] = time_ms(lambda: probes.interior(fpad).contiguous(), reps=20)
        library_ms = min(line["library_ms"], line["library_after_ms"])
        if timed:
            for _, name in probes.LOADS.values():
                library[name] = library_ms
        script_bytes = 27 * 4 * (20 * wy / (16 * 32) + 1)
        log("probes", kernel="window_copy", window=repr(label), y_off=y_off, wy=wy,
            dst_off=dst_off, stages=probes.window_stages(Z, wy, dst_off),
            **{k: f"{v:.4f}" for k, v in line.items()},
            tma_over_library=f"{line['tma_ms'] / library_ms:.3f}",
            ld16_over_library=f"{line['ld16_ms'] / library_ms:.3f}",
            gbps_216B_tma=f"{gbps(216, line['tma_ms']):.1f}",
            gbps_script_tma=f"{gbps(script_bytes, line['tma_ms']):.1f}")
    del fpad
    torch.cuda.empty_cache()
    t_window += time.perf_counter() - t_start
    counts = {k: v.launches for k, v in probes.KERNELS.items()}
    log("probes", launches=counts)
    if min(counts.values()) <= 0:
        raise RuntimeError("a probe kernel was not launched")
    return {"err": err, "times": times, "library": library, "kernels": dict(probes.KERNELS),
            "window_seconds": t_window}


def ab_cases():
    """(label, cfg, domain, u_in) of the A-B compare: the three apps at
    resolution 2 and the box under CUM_WELL and CUM."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_1, sim_2, sim_3
    from torch_cases import U_IN, bc_box

    dev = torch.device(DEVICE)
    where = WORK / "compare_ab"
    sim = sim_2.build(2, device=dev, streaming="AB", use_fused=True, results_parent=where)
    yield "sim_2_res2_AB", sim.cfg, sim.domain, None
    for app in (sim_1, sim_3):
        sim = app.build(2, device=dev, results_parent=where)
        yield f"{app.__name__.rsplit('.', 1)[1]}_res2", sim.cfg, sim.domain, sim.update_inflow(0.0)
    box = interop.domain_from_numpy(bc_box((24, 20, 150)), (False, False, True))
    for spec in (("CUM_WELL", "EQ_WELL", True), ("CUM", "EQ", False)):
        yield f"box_{spec[0]}", interop.config_from_spec(*spec, "AB"), box, U_IN


def phase_compare_ab(step_times: dict, floor_gbps: float) -> dict:
    """The A-B kernel against its plain version, one step from a seeded
    random state per geometry; then at 256^3, timed beside one even and
    one odd launch and the P1 floor of this call."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

    dev = torch.device(DEVICE)
    force = (FORCE_SMALL, 0.0, 0.0)
    worst_f = 0.0
    for label, cfg, dom, u_in in ab_cases():
        step = make_fused_step(cfg, dom, dev)
        f = rand_f(cfg, dom.shape, dev, seed=11)
        fk, rk, uk = step(f, NU, u_in=u_in, force=force)
        fp, rp, up = step.plain(f, NU, u_in=u_in, force=force)
        torch.cuda.synchronize()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        log("compare_ab", case=label, shape="x".join(map(str, dom.shape)),
            codes="+".join(sorted(c.name for c in step.codes)), max_df=d[0], max_drho=d[1],
            max_du=d[2], launches=step.kernel.launches)
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"ab_step vs plain on {label} out of tolerance: {d}")
        worst_f = max(worst_f, d[0])

    cfg, dom = flagship(BENCH_SHAPE, streaming="AB")
    step = make_fused_step(cfg, dom, dev)
    bench_force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    fk, rk, uk = step(f0, NU, force=bench_force)
    fp, rp, up = step.plain(f0, NU, force=bench_force)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"ab_step vs plain at 256^3 out of tolerance: {d}")
    out = torch.empty_like(f0)
    ms = time_ms(lambda: step(f0, NU, force=bench_force, out=out), reps=20)
    plain_ms = time_ms(lambda: step.plain(f0, NU, force=bench_force), reps=3)
    del f0, out
    torch.cuda.empty_cache()
    rate = gbps(AB_BYTES, ms)
    log("compare_ab", kernel="ab_step", shape="256^3", max_df=d[0], max_drho=d[1], max_du=d[2],
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", even_ms=f"{step_times['aa_even'][0]:.4f}",
        odd_ms=f"{step_times['aa_odd'][0]:.4f}", gbps_233B=f"{rate:.1f}",
        share_of_p1_floor=f"{rate / floor_gbps:.3f}", mlups_kernel=f"{np.prod(BENCH_SHAPE) / ms / 1e3:.1f}")
    return {"err": {"ab_step": max(worst_f, d[0])}, "times": {"ab_step": (ms, plain_ms)}}


def full_pair_cases():
    """(label, cfg, domain, u_in, force) of B1b's compare: sim_2's res-2
    duct, the box of every A-A code per variant and sim_1's A-A map at
    resolution SIM1_AA_PLAIN_RES (its moment inflow and OUTFLOW_RIGHT)."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_1, sim_2
    from torch_cases import AB_SPECS, U_IN, aa_box

    force = (FORCE_SMALL, 0.0, 0.0)
    sim = sim_2.build(2, device=torch.device(DEVICE), streaming="AA", use_fused=True,
                      results_parent=WORK / "compare_layouts")
    yield "sim_2_res2", sim.cfg, sim.domain, None, force
    box = interop.domain_from_numpy(aa_box((24, 20, 150)), (False, False, True))
    for name, spec in AB_SPECS.items():
        yield f"aa_box_{name}", interop.config_from_spec(*spec, "AA"), box, U_IN, force
    s1 = sim_1.build(SIM1_AA_PLAIN_RES, device=DEVICE, streaming="AA",
                     results_parent=WORK / "compare_layouts")
    yield (f"sim_1_res{SIM1_AA_PLAIN_RES}", s1.cfg, s1.domain, s1.update_inflow(0.0),
           s1.body_force(0.0))


def full_pair_vs_plain(pair, f, u_in, force) -> tuple:
    """One B1b pair from f against its plain version on the same input:
    (max |df|, |drho|, |du|, the kernel's output)."""
    import torch

    fk, rk, uk = pair(f, NU, u_in, force)
    fp, rp, up = pair.plain(f, NU, u_in, force)
    torch.cuda.synchronize()
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    del fp, rp, up
    return d + (fk,)


def in_turns(fns: dict, rounds: int, reps: int) -> dict:
    """name -> the CUDA-event ms of each round, the functions timed in
    turns (a, b, ..., then b, a, ... in the next round)."""
    out = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            out[name].append(time_ms(fns[name], reps=reps))
    return out


def phase_layouts(times: dict, floor_gbps: float, res: dict) -> dict:
    """The layout variants: the full-set A-A pair (B1b) and the site-major
    A-B step (B4s) against their plain versions on small cases, then at
    256^3 against their plain versions and timed beside the one-kernel
    pair (B1, in turns) and one even plus one odd launch (B2 + B3), and
    beside the A-B step (B4); B1b again on sim_1's A-A map at res 8, timed
    in turns beside B2 + B3 of the same instances.  B4s's launch count is
    its timing's; ``res``: the ptxas report of phase_build."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_1
    from tnl_lbm_tpu_torch.kernels.fused import (
        aa_variant,
        from_sitemajor,
        make_fused_step_sitemajor,
        to_sitemajor,
    )
    from tnl_lbm_tpu_torch.kernels.fused_aa import (
        make_fused_pair2_aa,
        make_fused_pair_aa,
        make_fused_step_aa,
    )

    dev = torch.device(DEVICE)
    force = (FORCE_SMALL, 0.0, 0.0)
    err = {"aa_pair_full": 0.0, "ab_step_sitemajor": 0.0}
    out_times = {}
    for label, cfg, dom, u_in, fvec in full_pair_cases():
        pair = make_fused_pair_aa(cfg, dom, dev)
        # a segment starting at X - 1 (the outflow plane), bit for bit the same
        edge = make_fused_pair_aa(cfg, dom, dev, seg_len=max(1, dom.shape[0] - 1))
        f = rand_f(cfg, dom.shape, dev, seed=5)
        worst = [0.0] * 3
        for _ in range(2):
            *d, fk = full_pair_vs_plain(pair, f, u_in, fvec)
            worst = [max(a, b) for a, b in zip(worst, d)]
            if not torch.equal(edge(f, NU, u_in, fvec)[0], fk):
                raise RuntimeError(f"aa_pair_full on {label}: a segment at X - 1 changed f")
            f = fk
        del f, fk
        torch.cuda.empty_cache()
        log("layouts", kernel="aa_pair_full", case=label, shape="x".join(map(str, dom.shape)),
            variant=pair.variant, pairs=2, max_df=worst[0], max_drho=worst[1], max_du=worst[2],
            segment_at_x_minus_1="equal", launches=pair.kernel.launches,
            geometry=json.dumps(pair.geometry()))
        if not (worst[0] <= TOL_F and worst[1] <= TOL_RHO and worst[2] <= TOL_U):
            raise RuntimeError(f"aa_pair_full vs plain on {label} out of tolerance: {worst}")
        err["aa_pair_full"] = max(err["aa_pair_full"], worst[0])

    cfg, dom = flagship(BENCH_SHAPE)
    pair = make_fused_pair_aa(cfg, dom, dev)
    # the full-set CUM_WELL instance on the same map, launched for this comparison only
    full_set = make_fused_pair_aa(cfg, dom, dev)
    full_set.variant = aa_variant(cfg, full_set.codes, lean=False)
    b1 = make_fused_pair2_aa(cfg, dom, dev)
    bench_force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    d = full_pair_vs_plain(pair, f0, None, bench_force)[:3]
    torch.cuda.empty_cache()
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"aa_pair_full vs plain at 256^3 out of tolerance: {d}")
    err["aa_pair_full"] = max(err["aa_pair_full"], d[0])
    d_full = full_pair_vs_plain(full_set, f0, None, bench_force)[:3]
    if not (d_full[0] <= TOL_F and d_full[1] <= TOL_RHO and d_full[2] <= TOL_U):
        raise RuntimeError(f"aa_pair_full (full set) vs plain at 256^3 out of tolerance: {d_full}")
    err["aa_pair_full"] = max(err["aa_pair_full"], d_full[0])
    spare = torch.empty_like(f0)
    turns = in_turns({"aa_pair_full": lambda: pair(f0, NU, force=bench_force),
                      "aa_pair_f32": lambda: b1(f0, NU, force=bench_force, out=spare),
                      "full_set": lambda: full_set(f0, NU, force=bench_force)},
                     rounds=4, reps=20)
    pair_ms = float(np.median(turns["aa_pair_full"]))
    plain_ms = time_ms(lambda: pair.plain(f0, NU, force=bench_force), reps=3)
    del f0, spare
    torch.cuda.empty_cache()
    out_times["aa_pair_full"] = (pair_ms, plain_ms)
    two_steps = times["aa_even"][0] + times["aa_odd"][0]
    b1_ms = float(np.median(turns["aa_pair_f32"]))
    instances = {name: {k: res[name].get(k, 0) for k in ("registers", "spill_stores",
                                                         "spill_loads")}
                 for name in FULL_PAIR_KERNEL_NAMES}
    log("layouts", kernel="aa_pair_full", shape="256^3", variant=pair.variant, max_df=d[0],
        max_drho=d[1], max_du=d[2], ms=f"{pair_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
        turns_ms="/".join(f"{v:.4f}" for v in turns["aa_pair_full"]),
        b1_f32_turns_ms="/".join(f"{v:.4f}" for v in turns["aa_pair_f32"]),
        b2_plus_b3_ms=f"{two_steps:.4f}", over_b1=f"{pair_ms / b1_ms:.3f}",
        full_set_turns_ms="/".join(f"{v:.4f}" for v in turns["full_set"]),
        full_set_over_lean=f"{np.median(turns['full_set']) / pair_ms:.3f}",
        full_set_max_df=d_full[0],
        over_b2_b3=f"{pair_ms / two_steps:.3f}", gbps_233B=f"{gbps(233, pair_ms):.1f}",
        share_of_233B_bound=f"{gbps(233, pair_ms) / HBM_PEAK_GBPS:.3f}",
        share_of_p1_floor=f"{gbps(233, pair_ms) / floor_gbps:.3f}",
        geometry=json.dumps(pair.geometry()), instances=json.dumps(instances))

    # sim_1's A-A map at res 8: the full set (CUM, eq_inv_cum) against B2 + B3
    s1 = sim_1.build(SIM1_RES, device=DEVICE, streaming="AA",
                     results_parent=WORK / "layouts_sim1")
    cfg, dom = s1.cfg, s1.domain
    u_in, fvec = s1.update_inflow(0.0), s1.body_force(0.0)
    full = make_fused_pair_aa(cfg, dom, dev)
    aa_step = make_fused_step_aa(cfg, dom, dev)
    f0 = rand_f(cfg, dom.shape, dev, seed=9)
    g, odd_out = f0.clone(), torch.empty_like(f0)
    macro = (torch.empty(dom.shape, device=dev), torch.empty((3,) + dom.shape, device=dev))

    def b2_b3():
        aa_step(g, NU, u_in=u_in, force=fvec, parity=0, macro_out=macro)
        aa_step(g, NU, u_in=u_in, force=fvec, parity=1, out=odd_out, macro_out=macro)

    s1_turns = in_turns({"aa_pair_full": lambda: full(f0, NU, u_in, fvec), "b2_b3": b2_b3},
                        rounds=4, reps=5)
    fk = full(f0, NU, u_in, fvec)[0]
    finite = bool(torch.isfinite(fk).all())
    del f0, g, odd_out, macro, fk
    torch.cuda.empty_cache()
    s1_ms = float(np.median(s1_turns["aa_pair_full"]))
    s1_two = float(np.median(s1_turns["b2_b3"]))
    sites = float(np.prod(dom.shape))
    log("layouts", kernel="aa_pair_full", case=f"sim_1_res{SIM1_RES}",
        shape="x".join(map(str, dom.shape)), variant=full.variant, ms=f"{s1_ms:.4f}",
        b2_plus_b3_ms=f"{s1_two:.4f}", over_b2_b3=f"{s1_ms / s1_two:.3f}",
        turns_ms="/".join(f"{v:.4f}" for v in s1_turns["aa_pair_full"]),
        b2_b3_turns_ms="/".join(f"{v:.4f}" for v in s1_turns["b2_b3"]),
        bound_ms=f"{233 * sites / (HBM_PEAK_GBPS * 1e9) * 1e3:.4f}", finite=finite,
        geometry=json.dumps(full.geometry()), launches=full.kernel.launches)
    if not finite:
        raise RuntimeError(f"aa_pair_full on sim_1 res {SIM1_RES}: non-finite output")
    dispatch = sim1_aa_dispatch()

    for label, cfg, dom, u_in in ab_cases():
        step = make_fused_step_sitemajor(cfg, dom, dev)
        fs = to_sitemajor(rand_f(cfg, dom.shape, dev, seed=11))
        fk, rk, uk = step(fs, NU, u_in=u_in, force=force)
        fp, rp, up = step.plain(fs, NU, u_in=u_in, force=force)
        torch.cuda.synchronize()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        zero = bool((fk[:, :, 27:] == 0).all())
        log("layouts", kernel="ab_step_sitemajor", case=label, shape="x".join(map(str, dom.shape)),
            max_df=d[0], max_drho=d[1], max_du=d[2], dummies_zero=zero)
        if not (zero and d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"ab_step_sitemajor vs plain on {label}: {d}, dummies zero {zero}")
        err["ab_step_sitemajor"] = max(err["ab_step_sitemajor"], d[0])

    cfg, dom = flagship(BENCH_SHAPE, streaming="AB")
    step = make_fused_step_sitemajor(cfg, dom, dev)
    fs = to_sitemajor(rand_f(cfg, dom.shape, dev, seed=7))
    fk, rk, uk = step(fs, NU, force=bench_force)
    fp, rp, up = step.plain(fs, NU, force=bench_force)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    zero = bool((fk[:, :, 27:] == 0).all())
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    if not (zero and d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"ab_step_sitemajor vs plain at 256^3: {d}, dummies zero {zero}")
    err["ab_step_sitemajor"] = max(err["ab_step_sitemajor"], d[0])
    step.reset_counts()
    ms = time_ms(lambda: step(fs, NU, force=bench_force), reps=20)
    plain_ms = time_ms(lambda: step.plain(fs, NU, force=bench_force), reps=3)
    del fs
    torch.cuda.empty_cache()
    out_times["ab_step_sitemajor"] = (ms, plain_ms)
    log("layouts", kernel="ab_step_sitemajor", shape="256^3", max_df=d[0], max_drho=d[1],
        max_du=d[2], ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
        ab_step_ms=f"{times['ab_step'][0]:.4f}", over_b4=f"{ms / times['ab_step'][0]:.3f}",
        gbps_253B=f"{gbps(SITEMAJOR_BYTES, ms):.1f}",
        share_of_p1_floor=f"{gbps(SITEMAJOR_BYTES, ms) / floor_gbps:.3f}",
        launches=step.kernel.launches)
    if step.kernel.launches <= 0:
        raise RuntimeError("ab_step_sitemajor was not launched")
    return {"err": err, "times": out_times, "pair_ms": pair_ms, "b1_ms": b1_ms,
            "full_set_ms": float(np.median(turns["full_set"])),
            "sim1_ms": s1_ms, "sim1_b2_b3_ms": s1_two, "instances": instances,
            "sim1_dispatch": dispatch,
            "kernels": {"aa_pair_full": pair.kernel, "ab_step_sitemajor": step.kernel}}


#: sim_1 res 8 A-A through Simulation: chunks of its steps_per_dispatch (10),
#: the first DISPATCH_WARM of each run untimed (the eager chunk, then a capture
#: from each of the two buffers a chunk of 5 pairs or 10 steps starts in),
#: then DISPATCH_ROUNDS chunks of each run in turns
DISPATCH_WARM, DISPATCH_ROUNDS = 3, 8


def sim1_aa_dispatch() -> dict:
    """sim_1 at SIM1_RES with ``--streaming AA`` through ``Simulation``:
    built with ``pair_dispatch="auto"`` (the probe's two times and its
    pick, rechecked by ``auto_choice``), then a run in pairs (B1b) and a
    run per step (B2/B3) from the same start, their ``_advance`` chunks
    (CUDA graph replays after DISPATCH_WARM) in turns; each run's MLUPS over its
    timed chunks, f, rho and u of the two within TOL_APP, one B1b launch a
    pair and none of B2/B3 on the paired run.  Returns the paired run's
    B1b launches, counted from the end of its sim_init, and the figures."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_1

    label = f"sim_1_res{SIM1_RES}_AA"
    sim = sim_1.build(SIM1_RES, device=DEVICE, streaming="AA", pair_dispatch="auto",
                      results_parent=WORK / "sim1_aa_auto")
    sim.sim_init()
    auto_choice(sim, label)
    chose = "pair" if sim.pair_dispatch else "per_step"
    probe_ms = sim.pair_probe_ms
    del sim
    torch.cuda.empty_cache()

    runs = {}
    for tag, pd in (("pairs", True), ("per_step", False)):
        sim = counting_from_init(sim_1.build(SIM1_RES, device=DEVICE, streaming="AA",
                                             pair_dispatch=pd,
                                             results_parent=WORK / f"sim1_aa_{tag}"))
        sim.sim_init()
        runs[tag] = sim
    paired, stepped = runs["pairs"], runs["per_step"]
    if type(paired._pair).__name__ != "FusedPairAAFull" or stepped._pair is not None:
        raise RuntimeError(f"{label}: pair dispatch built {type(paired._pair).__name__}, "
                           f"not B1b (FusedPairAAFull)")
    chunk = paired.steps_per_dispatch
    seconds = {tag: 0.0 for tag in runs}
    for r in range(DISPATCH_WARM + DISPATCH_ROUNDS):
        for tag in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            t0 = runs[tag]._compute_time
            runs[tag]._advance(chunk)
            if r >= DISPATCH_WARM:
                seconds[tag] += runs[tag]._compute_time - t0
    steps = paired.iterations
    sites = float(np.prod(paired.domain.shape))
    mlups = {tag: sites * chunk * DISPATCH_ROUNDS / seconds[tag] / 1e6 for tag in runs}
    d = {n: max_diff(getattr(paired, n), getattr(stepped, n)) for n in ("f", "rho", "u")}
    equal = all(torch.equal(getattr(paired, n), getattr(stepped, n)) for n in ("f", "rho", "u"))
    launches = {"pair": paired._pair.kernel.launches, "pair_even": paired._step.even.launches,
                "pair_odd": paired._step.odd.launches, "step_even": stepped._step.even.launches,
                "step_odd": stepped._step.odd.launches}
    finite = all(bool(torch.isfinite(getattr(paired, n)).all()) for n in ("rho", "u"))
    log("layouts", path=label, route="Simulation", auto_chose=chose,
        probe_pair_ms=f"{probe_ms[0]:.4f}", probe_per_step_ms=f"{probe_ms[1]:.4f}",
        steps=steps, timed_steps=chunk * DISPATCH_ROUNDS, mlups_pairs=f"{mlups['pairs']:.1f}",
        mlups_per_step=f"{mlups['per_step']:.1f}",
        pairs_over_per_step=f"{mlups['pairs'] / mlups['per_step']:.3f}",
        graph_replays=f"{paired.graph_replays}/{stepped.graph_replays}",
        max_df=d["f"], max_drho=d["rho"], max_du=d["u"], bit_equal=equal, finite=finite,
        **{f"launches_{k}": v for k, v in launches.items()})
    if not (finite and d["f"] <= TOL_APP and d["rho"] <= TOL_APP and d["u"] <= TOL_APP):
        raise RuntimeError(f"{label}: the paired run against the per-step run: {d}, "
                           f"finite {finite}")
    if (launches["pair"] * 2 != steps or launches["pair_even"] or launches["pair_odd"]
            or launches["step_even"] + launches["step_odd"] != steps):
        raise RuntimeError(f"{label}: launches {launches} for {steps} steps a run")
    if paired.graph_replays < DISPATCH_ROUNDS or stepped.graph_replays < DISPATCH_ROUNDS:
        raise RuntimeError(f"{label}: the chunks did not replay their graphs")
    b1b_launches = launches["pair"]
    del paired, stepped, runs
    torch.cuda.empty_cache()
    return {"launches": b1b_launches, "mlups": mlups, "chose": chose, "probe_ms": probe_ms,
            "max_diff": d}


def phase_bench() -> dict:
    """The port's benchmark entry (``python -m tnl_lbm_tpu_torch.bench``),
    run in this process through its ``main`` and read from the JSON line it
    prints: the one-kernel pair (B1) per store dtype and the full-set
    pair (B1b).  Each run counts its kernels' launches from 0; every one
    must be > 0.  Returns kernel name -> launches."""
    import contextlib
    import io

    from tnl_lbm_tpu_torch import bench

    launches = {}
    for kernel, storage in (("pair2", "f32"), ("pair2", "f16"), ("pair2", "bf16"),
                            ("pair", "f32")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(["--kernel", kernel, "--storage", storage])
        lines = buf.getvalue().strip().splitlines()
        rec = json.loads(lines[-1])
        log("bench", kernel=kernel, storage=storage, mlups=rec["value"],
            bound_mlups=rec["bound_mlups"], share_of_bound=rec["share_of_bound"],
            launches=rec["launches"], plain_calls=rec["plain_calls"], seconds=rec["seconds"],
            device=repr(rec["device"]), nvidia_smi=repr(rec["nvidia_smi"]))
        if (len(lines) != 1 or min(rec["launches"].values()) <= 0 or rec["plain_calls"] != 0
                or not rec["value"] > 0):
            raise RuntimeError(f"bench {kernel} {storage}: {lines}")
        for name, n in rec["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


def scaled_diff(a, b, scale) -> float:
    """max |a - b| / scale, one component at a time: the absolute
    difference where the operands are at most 1 in magnitude, the relative
    one where the WALL_BODY walls have grown them."""
    if a.ndim == 4:
        return max(scaled_diff(x, y, scale) for x, y in zip(a, b))
    return float(((a.double() - b.double()).abs() / scale).max())


def coupled_cases():
    """(label, NSE domain, ADE domain) of the B6 and B7 compares:
    sim_coupled's res-2 maps, the boxes of every code (NSE ``bc_box`` and
    ADE ``ade_box``, Z = 150) and a periodic box (FLUID with a
    PERIODIC-coded block, every axis periodic), the geometries of
    tests/torch_cases.py at these shapes."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.models import D3Q7
    from torch_cases import ade_case, channel

    sim = sim_coupled.build(2, device=DEVICE, use_fused=True, results_parent=WORK / "compare_ade")
    yield "sim_coupled_res2", sim.domain, sim.ade_domain
    shape = (16, 20, 150)
    yield ("box", interop.domain_from_numpy(*channel("box", shape)),
           interop.domain_from_numpy(*ade_case("box", shape), lat=D3Q7))
    m, periodic = ade_case("periodic", (24, 20, 150))
    yield ("periodic", interop.domain_from_numpy(np.zeros_like(m), periodic),
           interop.domain_from_numpy(m, periodic, lat=D3Q7))


def phase_compare_ade() -> dict:
    """B6 against its plain version, one step per geometry, collision and
    kind of nu."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from torch_cases import ADE_COLLISIONS, PHI_IN, TCOEF, seeded_ade

    dev = torch.device(DEVICE)
    worst_g = 0.0
    for label, _, adom in coupled_cases():
        worst = [0.0, 0.0]
        g, u, nu_field = seeded_ade(adom.shape, dev)
        for collision in ADE_COLLISIONS:
            step = make_fused_ade_step(interop.ade_config_from_spec(collision), adom, dev,
                                       variable_diffusion=True, transfer_coeff=TCOEF)
            for nu in (NU_ADE, nu_field):
                gk, pk = step(g, u, nu, phi_in=PHI_IN)
                gp, pp = step.plain(g, u, nu, phi_in=PHI_IN)
                torch.cuda.synchronize()
                d = (max_diff(gk, gp), max_diff(pk, pp))
                if not (d[0] <= TOL_G and d[1] <= TOL_PHI):
                    raise RuntimeError(f"ade_step vs plain on {label}, {collision}, "
                                       f"nu {'field' if torch.is_tensor(nu) else 'scalar'}: {d}")
                worst = [max(a, b) for a, b in zip(worst, d)]
        log("compare_ade", case=label, shape="x".join(map(str, adom.shape)),
            codes="+".join(sorted(c.name for c in step.codes)), collisions=len(ADE_COLLISIONS),
            nu="scalar+field", max_dg=worst[0], max_dphi=worst[1])
        worst_g = max(worst_g, worst[0])
    return {"ade_step": worst_g}


def phase_compare_coupled() -> dict:
    """B7 against its plain version and against B4 then B6, one step per
    geometry, NSE variant and ADE collision, with a nu field."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step
    from torch_cases import AB_SPECS, ADE_COLLISIONS, PHI_IN, TCOEF, U_IN, seeded_ade

    dev = torch.device(DEVICE)
    worst_state, bit_equal = 0.0, True
    args = dict(u_in=U_IN, force=(FORCE_SMALL, 0.0, 0.0), phi_in=PHI_IN)
    for label, dom, adom in coupled_cases():
        worst = [0.0] * 5
        g, _, nu_field = seeded_ade(dom.shape, dev)
        for spec in AB_SPECS.values():
            cfg = interop.config_from_spec(*spec, "AB")
            f = rand_f(cfg, dom.shape, dev, seed=11)
            b4 = make_fused_step(cfg, dom, dev)
            for collision in ADE_COLLISIONS:
                acfg = interop.ade_config_from_spec(collision)
                one = make_fused_coupled_step(cfg, dom, acfg, adom, dev, variable_diffusion=True,
                                              transfer_coeff=TCOEF)
                b6 = make_fused_ade_step(acfg, adom, dev, variable_diffusion=True,
                                         transfer_coeff=TCOEF)
                k = one(f, g, NU, nu_field, **args)
                p = one.plain(f, g, NU, nu_field, **args)
                f2, r2, u2 = b4(f, NU, u_in=args["u_in"], force=args["force"])
                g2, p2 = b6(g, u2, nu_field, phi_in=PHI_IN)
                two = (f2, g2, r2, u2, p2)
                torch.cuda.synchronize()
                for ref in (p, two):
                    d = [max_diff(a, b) for a, b in zip(k, ref)]  # f, g, rho, u, phi
                    if not (d[0] <= TOL_F and d[1] <= TOL_G and d[2] <= TOL_RHO
                            and d[3] <= TOL_U and d[4] <= TOL_PHI):
                        raise RuntimeError(f"coupled_ab on {label}, {spec[0]}/{spec[1]}, "
                                           f"{collision}: {d}")
                    worst = [max(a, b) for a, b in zip(worst, d)]
                bit_equal &= all(torch.equal(a, b) for a, b in zip(k, two))
        log("compare_coupled", case=label, shape="x".join(map(str, dom.shape)),
            instances=len(AB_SPECS) * len(ADE_COLLISIONS), max_df=worst[0], max_dg=worst[1],
            max_drho=worst[2], max_du=worst[3], max_dphi=worst[4],
            b7_equals_b4_then_b6_bitwise=bit_equal)
        worst_state = max(worst_state, worst[0], worst[1])
    return {"coupled_ab": worst_state, "bit_equal": bit_equal}


def coupled_bench():
    """The bench duct with an ADE lattice: WALL on the y and z faces of
    both lattices, periodic x; CUM_WELL and CLBM."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.models import D3Q7
    from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

    cfg, dom = flagship(BENCH_SHAPE, streaming="AB")
    m = np.zeros(BENCH_SHAPE, np.uint8)
    m[:, 0] = m[:, -1] = ADEGEO.WALL
    m[:, :, 0] = m[:, :, -1] = ADEGEO.WALL
    return cfg, dom, interop.ade_config_from_spec("CLBM"), interop.domain_from_numpy(
        m, (True, False, False), lat=D3Q7)


def phase_time_coupled(floor_gbps: float) -> dict:
    """B6, B7 and B4 then B6 at 256^3: one step of B6 and B7 against their
    plain versions, then timed beside B4 and the P1 floor of this call."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step
    from torch_cases import seeded_ade

    dev = torch.device(DEVICE)
    cfg, dom, acfg, adom = coupled_bench()
    b4, b6 = make_fused_step(cfg, dom, dev), make_fused_ade_step(acfg, adom, dev)
    b7 = make_fused_coupled_step(cfg, dom, acfg, adom, dev)
    force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    g0, u0, _ = seeded_ade(dom.shape, dev)
    d6 = [max_diff(a, b) for a, b in zip(b6(g0, u0, NU_ADE), b6.plain(g0, u0, NU_ADE))]
    d7 = [max_diff(a, b) for a, b in zip(b7(f0, g0, NU, NU_ADE, force=force),
                                         b7.plain(f0, g0, NU, NU_ADE, force=force))]
    torch.cuda.empty_cache()
    if not (d6[0] <= TOL_G and d6[1] <= TOL_PHI and d7[0] <= TOL_F and d7[1] <= TOL_G
            and d7[2] <= TOL_RHO and d7[3] <= TOL_U and d7[4] <= TOL_PHI):
        raise RuntimeError(f"B6 / B7 vs plain at 256^3 out of tolerance: {d6}, {d7}")
    fo, go = torch.empty_like(f0), torch.empty_like(g0)

    def two():
        _, _, u = b4(f0, NU, force=force, out=fo)
        b6(g0, u, NU_ADE, out=go)

    ms = {
        "ab_step": time_ms(lambda: b4(f0, NU, force=force, out=fo), reps=20),
        "ade_step": time_ms(lambda: b6(g0, u0, NU_ADE, out=go), reps=20),
        "coupled_ab": time_ms(lambda: b7(f0, g0, NU, NU_ADE, force=force, out_f=fo, out_g=go),
                              reps=20),
        "ab_then_ade": time_ms(two, reps=20),
    }
    plain = {"ade_step": time_ms(lambda: b6.plain(g0, u0, NU_ADE), reps=3),
             "coupled_ab": time_ms(lambda: b7.plain(f0, g0, NU, NU_ADE, force=force), reps=3)}
    del f0, g0, u0, fo, go
    torch.cuda.empty_cache()
    for name, nbytes in (("ab_step", AB_BYTES), ("ade_step", ADE_BYTES),
                         ("coupled_ab", COUPLED_BYTES), ("ab_then_ade", TWO_KERNEL_BYTES)):
        rate = gbps(nbytes, ms[name])
        log("time_coupled", kernel=name, shape="256^3", ms=f"{ms[name]:.4f}",
            plain_ms=f"{plain[name]:.2f}" if name in plain else "n/a",
            **{f"gbps_{nbytes}B": f"{rate:.1f}"}, share_of_p1_floor=f"{rate / floor_gbps:.3f}")
    log("time_coupled", b7_over_b4_then_b6=f"{ms['coupled_ab'] / ms['ab_then_ade']:.3f}",
        max_dg_b6=d6[0], max_dphi_b6=d6[1], max_df_b7=d7[0], max_dg_b7=d7[1])
    return {"times": {k: (ms[k], plain[k]) for k in plain},
            "err": {"ade_step": d6[0], "coupled_ab": max(d7[0], d7[1])}}


def coupled_aa_cases():
    """(label, NSE domain, ADE domain) of the B8 compare: sim_coupled's
    res-2 A-A maps, then tests/torch_cases.py's ``coupled_aa_cases`` with
    Z = 150, which the block's 128 z sites do not divide."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.models import D3Q7
    import torch_cases

    sim = sim_coupled.build(2, device=DEVICE, use_fused=True, streaming="AA",
                            results_parent=WORK / "compare_aa")
    yield "sim_coupled_res2_AA", sim.domain, sim.ade_domain
    for label, mn, pn, ma, pa in torch_cases.coupled_aa_cases((16, 20, 150)):
        yield (label, interop.domain_from_numpy(mn, pn),
               interop.domain_from_numpy(ma, pa, lat=D3Q7))


def phase_compare_coupled_aa() -> dict:
    """B8 against its plain version per geometry, NSE variant and ADE
    collision, with a nu field: the even then the odd parity, each from the
    same input on both sides; and its NSE fields against the A-A step
    kernels (B2, B3) run alone, bit-equality printed."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa
    from torch_cases import AB_SPECS, ADE_COLLISIONS, PHI_IN, U_IN, seeded_ade

    dev = torch.device(DEVICE)
    err, bit_equal = {"coupled_aa_even": 0.0, "coupled_aa_odd": 0.0}, True
    args = dict(u_in=U_IN, force=(FORCE_SMALL, 0.0, 0.0))
    for label, dom, adom in coupled_aa_cases():
        worst = [0.0] * 5
        g0, _, nu_field = seeded_ade(dom.shape, dev)
        for spec in AB_SPECS.values():
            cfg = interop.config_from_spec(*spec, "AA")
            f0 = rand_f(cfg, dom.shape, dev, seed=11)
            alone = make_fused_step_aa(cfg, dom, dev, lean=False)  # B8's NSE instance
            for collision in ADE_COLLISIONS:
                pair = make_fused_coupled_step_aa(cfg, dom, interop.ade_config_from_spec(
                    collision, "AA"), adom, dev, variable_diffusion=True)
                f, g = f0, g0
                for parity, name in ((0, "coupled_aa_even"), (1, "coupled_aa_odd")):
                    p = pair.plain(f, g, NU, nu_field, phi_in=PHI_IN, parity=parity, **args)
                    a = alone(f.clone(), NU, parity=parity, **args)
                    k = pair(f.clone(), g.clone(), NU, nu_field, phi_in=PHI_IN, parity=parity,
                             **args)
                    torch.cuda.synchronize()
                    d = [max_diff(x, y) for x, y in zip(k, p)]  # f, g, rho, u, phi
                    if not (d[0] <= TOL_F and d[1] <= TOL_G and d[2] <= TOL_RHO
                            and d[3] <= TOL_U and d[4] <= TOL_PHI):
                        raise RuntimeError(f"{name} on {label}, {spec[0]}/{spec[1]}, "
                                           f"{collision}: {d}")
                    da = [max_diff(x, y) for x, y in zip((k[0], k[2], k[3]), a)]
                    if not (da[0] <= TOL_F and da[1] <= TOL_RHO and da[2] <= TOL_U):
                        raise RuntimeError(f"{name} NSE fields vs B2/B3 on {label}: {da}")
                    bit_equal &= all(torch.equal(x, y) for x, y in zip((k[0], k[2], k[3]), a))
                    worst = [max(x, y) for x, y in zip(worst, d)]
                    err[name] = max(err[name], d[0], d[1])
                    f, g = k[0], k[1]
        log("compare_coupled_aa", case=label, shape="x".join(map(str, dom.shape)),
            instances=len(AB_SPECS) * len(ADE_COLLISIONS), parities="even+odd",
            nse_codes="+".join(sorted(c.name for c in dom.codes_present())),
            ade_codes="+".join(sorted(c.name for c in adom.codes_present())), max_df=worst[0],
            max_dg=worst[1], max_drho=worst[2], max_du=worst[3], max_dphi=worst[4],
            b8_nse_equals_b2_b3_bitwise=bit_equal)
    return {"err": err, "bit_equal": bit_equal}


def phase_time_coupled_aa(step_times: dict, floor_gbps: float) -> dict:
    """B8 even and odd at 256^3 (the coupled bench duct under A-A, scalar
    nu): one launch of each against its plain version, then timed beside
    B2 + B3 of this call and the P1 floor, GB/s at 294 B/site."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa
    from torch_cases import seeded_ade

    dev = torch.device(DEVICE)
    cfg, dom, acfg, adom = coupled_bench()
    cfg, acfg = (dataclasses.replace(c, streaming="AA") for c in (cfg, acfg))
    pair = make_fused_coupled_step_aa(cfg, dom, acfg, adom, dev)
    force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    g0, _, _ = seeded_ade(dom.shape, dev)
    fo, go = torch.empty_like(f0), torch.empty_like(g0)
    times, err = {}, {}
    for parity, name in ((0, "coupled_aa_even"), (1, "coupled_aa_odd")):
        k = pair(f0.clone(), g0.clone(), NU, NU_ADE, force=force, parity=parity)
        p = pair.plain(f0, g0, NU, NU_ADE, force=force, parity=parity)
        d = [max_diff(a, b) for a, b in zip(k, p)]
        del k, p
        torch.cuda.empty_cache()
        if not (d[0] <= TOL_F and d[1] <= TOL_G and d[2] <= TOL_RHO and d[3] <= TOL_U
                and d[4] <= TOL_PHI):
            raise RuntimeError(f"{name} vs plain at 256^3 out of tolerance: {d}")
        fw, gw = f0.clone(), g0.clone()
        ms = time_ms(lambda: pair(fw, gw, NU, NU_ADE, force=force, parity=parity, out_f=fo,
                                  out_g=go), reps=20)
        plain_ms = time_ms(lambda: pair.plain(f0, g0, NU, NU_ADE, force=force, parity=parity),
                           reps=3)
        del fw, gw
        torch.cuda.empty_cache()
        times[name], err[name] = (ms, plain_ms), max(d[0], d[1])
        rate = gbps(COUPLED_BYTES, ms)
        log("time_coupled_aa", kernel=name, shape="256^3", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", **{f"gbps_{COUPLED_BYTES}B": f"{rate:.1f}"},
            share_of_p1_floor=f"{rate / floor_gbps:.3f}",
            step_kernel_ms=f"{step_times['aa_even' if parity == 0 else 'aa_odd'][0]:.4f}",
            max_df=d[0], max_dg=d[1], max_drho=d[2], max_du=d[3], max_dphi=d[4])
    del f0, g0, fo, go
    torch.cuda.empty_cache()
    pair_ms = times["coupled_aa_even"][0] + times["coupled_aa_odd"][0]
    steps_ms = step_times["aa_even"][0] + step_times["aa_odd"][0]
    log("time_coupled_aa", b8_pair_ms=f"{pair_ms:.4f}", b2_plus_b3_ms=f"{steps_ms:.4f}",
        b8_over_b2_b3=f"{pair_ms / steps_ms:.3f}")
    return {"times": times, "err": err}


def counting_from_init(sim):
    """Set the launch and plain-call counts and the peak-memory mark to 0 at
    the end of ``sim_init``, just before the stepping loop.  A subclass and
    not a wrapped method: a closure over ``sim`` would be a reference cycle
    that keeps the run's device state alive after ``del``."""
    import torch

    class Counted(type(sim)):
        def sim_init(self):
            super().sim_init()
            for k in (self._step, self._pair, getattr(self, "_ade_step", None),
                      getattr(self, "_coupled_step", None), getattr(self, "resident", None)):
                if hasattr(k, "reset_counts"):
                    k.reset_counts()
            torch.cuda.reset_peak_memory_stats()

    sim.__class__ = Counted
    return sim


def bench_sim(pair_dispatch, storage=None, steps: int | None = None, streaming="AA"):
    """Simulation on the 256^3 bench duct, counted from the end of sim_init."""
    from tnl_lbm_tpu_torch.sim.state import Simulation

    class BenchDuct(Simulation):
        def body_force(self, phys_time):
            return np.array([FORCE_BENCH, 0.0, 0.0])

    cfg, dom = flagship(BENCH_SHAPE, storage, streaming)
    steps = BENCH_STEPS if steps is None else steps
    tag = f"{streaming}_{pair_dispatch}_{storage or 'f32'}"
    sim = counting_from_init(BenchDuct(
        cfg, dom, device=DEVICE, sim_id=f"bench_duct_{tag}", results_parent=WORK / "main",
        phys_final_time=steps * dom.units.phys_dt, steps_per_dispatch=10, use_fused=True,
        pair_dispatch=pair_dispatch))
    if not sim.run():
        raise RuntimeError(f"main-path run {tag} failed (NaN or refused)")
    return sim


def kernel_launches(sim) -> dict:
    """Launch counts of the kernels a Simulation dispatched to."""
    step = sim._step
    if hasattr(step, "route"):  # a hooked step: every kernel of its routes, by name
        launches = {k.name: k.launches for w in step.kernels for k in cuda_kernels(w)}
        if hasattr(sim, "coupled_kernel"):
            launches["ade"] = sim._ade_step.kernel.launches
        return launches
    if hasattr(sim, "coupled_kernel") and sim.cfg.streaming == "AA":
        pair = sim._coupled_step
        return {"even": step.even.launches, "odd": step.odd.launches,
                "coupled_even": pair.even.launches, "coupled_odd": pair.odd.launches}
    if hasattr(sim, "coupled_kernel"):
        return {"ab": step.kernel.launches, "ade": sim._ade_step.kernel.launches,
                "coupled": sim._coupled_step.kernel.launches if sim._coupled_step else 0}
    if hasattr(step, "even"):
        launches = {"even": step.even.launches, "odd": step.odd.launches}
        launches["pair"] = sim._pair.kernel.launches if sim._pair else 0
        return launches
    if sim.cfg.lat.D == 2:  # B5 per step, and its resident chunk's (torch_cases.resident_route)
        chunk = getattr(sim, "resident", None)
        return {"d2q9": step.kernel.launches, "d2q9_chunk": chunk.kernel.launches if chunk else 0}
    return {"ab": step.kernel.launches}


def run_figures(sim) -> tuple[float, float, float]:
    """(ms/step, MLUPS, peak GB) of a Simulation's counted run."""
    import torch

    steps = sim.iterations
    return (sim._compute_time / steps * 1e3,
            float(np.prod(sim.domain.shape)) * steps / sim._compute_time / 1e6,
            torch.cuda.max_memory_allocated() / 1e9)


def report_main(sim, label: str) -> dict:
    import torch

    steps = sim.iterations
    ms_step, mlups, peak_gb = run_figures(sim)  # before the checks' own temporaries
    finite = bool(torch.isfinite(sim.rho).all()) and bool(torch.isfinite(sim.u).all())
    plain = sum(getattr(k, "plain_calls", 0) for k in (
        sim._step, sim._pair, getattr(sim, "_ade_step", None), getattr(sim, "_coupled_step", None),
        getattr(sim, "resident", None)))
    launches = kernel_launches(sim)
    log("main", path=label, shape="x".join(map(str, sim.domain.shape)), steps=steps,
        ms_per_step=f"{ms_step:.4f}", mlups=f"{mlups:.1f}", max_memory_allocated_gb=f"{peak_gb:.3f}",
        **{f"launches_{k}": v for k, v in launches.items()}, plain_calls=plain, finite=finite)
    if plain != 0 or not finite:
        raise RuntimeError(f"{label}: called the plain version or produced non-finite output")
    return launches


def auto_choice(sim, label: str) -> None:
    """The "auto" probe's two times (``Simulation.pair_probe_ms``) beside the
    same two routes timed again by the probe's own helper
    (``Simulation.time_pair_chains``) over longer chains, 5 chains of 20
    pairs each; where those chains separate the routes (every chain of one
    faster than every chain of the other, the medians more than 10% apart:
    ``torch_cases.separated_faster``), the probe must have picked the
    faster.  Small lattices are launch-bound: there the chains overlap and
    the check gives no verdict, which it logs."""
    from torch_cases import chain_range, separated_faster

    t_pair, t_steps = sim.pair_probe_ms
    c_pair, c_steps = sim.time_pair_chains(pairs=20, chains=5)
    faster = separated_faster(c_pair, c_steps)
    agrees = faster is None or bool(sim.pair_dispatch) == (faster == 0)
    log("main", path="auto", shape=label, chose="pair" if sim.pair_dispatch else "per_step",
        probe_pair_ms=f"{t_pair:.4f}", probe_per_step_ms=f"{t_steps:.4f}",
        long_pair_ms=f"{np.median(c_pair):.4f}", long_per_step_ms=f"{np.median(c_steps):.4f}",
        long_pair_ms_range=chain_range(c_pair), long_per_step_ms_range=chain_range(c_steps),
        separated=("none", "pair", "per_step")[0 if faster is None else faster + 1],
        agrees=agrees)
    if not agrees:
        raise RuntimeError(f"auto at {label} chose {'pair' if sim.pair_dispatch else 'per-step'} "
                           f"though every chain of the other route was faster: pair "
                           f"{chain_range(c_pair)} ms, per-step {chain_range(c_steps)} ms")


def phase_main_path() -> dict:
    """Per-step dispatch, the "auto" probe, then pair dispatch per store dtype."""
    import torch

    sim = bench_sim(False)
    launches = report_main(sim, "per_step")
    if sim.iterations != BENCH_STEPS or launches["even"] <= 0 or launches["odd"] <= 0:
        raise RuntimeError("the per-step path did not run through both kernels")
    kernels = {"aa_even": sim._step.even, "aa_odd": sim._step.odd}
    del sim
    torch.cuda.empty_cache()

    sim = bench_sim("auto", steps=20)
    launches = report_main(sim, "auto")
    auto_choice(sim, "256^3")
    if launches["pair" if sim.pair_dispatch else "even"] <= 0:
        raise RuntimeError("the auto path did not run through the dispatch it chose")
    del sim
    torch.cuda.empty_cache()
    from tnl_lbm_tpu_torch.apps import sim_2

    sim = sim_2.build(2, device=torch.device(DEVICE), streaming="AA", use_fused=True,
                      results_parent=WORK / "auto_res2")
    sim.sim_init()
    auto_choice(sim, "sim_2_res2")
    del sim
    torch.cuda.empty_cache()

    for store in STORES:
        sim = bench_sim(True, storage=store)
        launches = report_main(sim, f"pair_{store}")
        if sim.iterations != BENCH_STEPS or launches["pair"] <= 0 or sim.f.dtype != torch.float32:
            raise RuntimeError(f"the pair path ({store}) did not run through the pair kernel")
        kernels[f"aa_pair_{store}"] = sim._pair.kernel
        del sim
        torch.cuda.empty_cache()

    sim = bench_sim(False, streaming="AB")
    launches = report_main(sim, "ab_step")
    if sim.iterations != BENCH_STEPS or launches["ab"] != BENCH_STEPS:
        raise RuntimeError("the A-B path did not run every step through the A-B kernel")
    ab = sim._step.kernel
    del sim
    torch.cuda.empty_cache()

    sim = sim1_main_path()
    launches = report_main(sim, f"sim_1_res{SIM1_RES}")
    if sim.iterations != APP_STEPS or launches["ab"] != APP_STEPS:
        raise RuntimeError("sim_1 did not run every step through the A-B kernel")
    sim1_launches = launches["ab"]
    err = {"ab_step": sim1_kernel_vs_plain(sim)}
    del sim
    torch.cuda.empty_cache()

    sim = sim1_main_path("AA")
    launches = report_main(sim, f"sim_1_res{SIM1_RES}_AA")
    half = APP_STEPS // 2
    if (sim.iterations != APP_STEPS or sim._pair is not None
            or launches != {"even": half, "odd": APP_STEPS - half, "pair": 0}):
        raise RuntimeError(f"sim_1 A-A did not run every step through B2/B3: {launches}")
    log("main", path=f"sim_1_res{SIM1_RES}_AA", variant=sim._step.variant,
        codes="+".join(sorted(c.name for c in sim._step.codes)))
    for name in ("aa_even", "aa_odd"):
        kernels[name] = dataclasses.replace(kernels[name], launches=kernels[name].launches
                                            + launches[name[3:]])
    del sim
    torch.cuda.empty_cache()
    err.update(sim1_aa_kernel_vs_plain())

    coupled = coupled_main_path()
    kernels.update(coupled["kernels"])
    err.update(coupled["err"])
    # the JSON record counts the launches of every A-B main path
    kernels["ab_step"] = dataclasses.replace(
        ab, launches=ab.launches + sim1_launches + coupled["ab_launches"])
    return {"kernels": kernels, "err": err}


def collision_compare(cid: str, eq) -> dict:
    """The per-step kernels' instance of a collision (``COLLISION_CASES``)
    against the plain versions on the box of every code, from a seeded
    state off its equilibrium: one A-B step (``bc_box``), one A-A even step
    then one odd step (``aa_box``), each from the same input on both sides.
    kernel -> (max |df|, |drho|, |du|)."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
    from torch_cases import U_IN, aa_box, bc_box, collision_spec, collision_state

    out, force = {}, (1e-5, -2e-6, 3e-6)
    for streaming, m in (("AB", bc_box(COLLISION_BOX)), ("AA", aa_box(COLLISION_BOX))):
        cfg = interop.config_from_spec(**collision_spec(cid, streaming, eq))
        dom = interop.domain_from_numpy(m, (False, False, True))
        f = collision_state(cfg, COLLISION_BOX, DEVICE)
        if streaming == "AB":
            step = make_fused_step(cfg, dom, DEVICE)
            runs = (("ab_step", 0),)
        else:
            step = make_fused_step_aa(cfg, dom, DEVICE)
            runs = (("aa_even", 0), ("aa_odd", 1))
        for name, parity in runs:
            p = step.plain(f, NU, u_in=U_IN, force=force, parity=parity)
            k = step(f.clone(), NU, u_in=U_IN, force=force, parity=parity)
            torch.cuda.synchronize()
            out[name] = tuple(max_diff(a, b) for a, b in zip(k, p))
            f = k[0]
    return out


def collision_sim(cid: str, streaming: str, pair_dispatch=False):
    """Simulation on the 256^3 bench duct under collision ``cid`` with its
    natural equilibrium, COLLISION_STEPS steps counted from the end of
    sim_init: per step, or on A-A with ``pair_dispatch`` ("auto": the probe
    times the full-set pair B1b against per step and keeps the faster)."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.sim.state import Simulation
    from torch_cases import collision_spec

    class BenchDuct(Simulation):
        def body_force(self, phys_time):
            return np.array([FORCE_BENCH, 0.0, 0.0])

    _, dom = flagship(BENCH_SHAPE)
    cfg = interop.config_from_spec(**collision_spec(cid, streaming))
    sim = counting_from_init(BenchDuct(
        cfg, dom, device=DEVICE, sim_id=f"collision_{cid}_{streaming}_{pair_dispatch}",
        results_parent=WORK / "collisions", phys_final_time=COLLISION_STEPS * dom.units.phys_dt,
        steps_per_dispatch=10, use_fused=True,
        pair_dispatch=pair_dispatch if streaming == "AA" else False))
    if not sim.run():
        raise RuntimeError(f"the {cid} {streaming} run failed (NaN or refused)")
    return sim


def phase_collisions(floor_gbps: float, res: dict, ops: dict, site_ops: dict) -> dict:
    """The rest of the D3Q27 collision set on the per-step kernels (B4, B2,
    B3; csrc/coll_*.cu).  First each instance against its plain version on
    the box of every code (``collision_compare``; KBC_N1 also with the
    entropic equilibrium, SRT with the inverse-cumulant one: the run-time
    equilibrium's other kinds); |df| over 1e-6 (KBC too), |drho| over 2e-6
    or |du| over 1e-6 fails.  Then each id through ``Simulation`` on the
    256^3 bench duct, A-B and A-A per step (pair dispatch off: the pair's
    runs are ``phase_collision_routes``'), each run's launch counts set to
    0 at the end of sim_init and read after it: MLUPS, launches (one a
    step, no pair), and each kernel timed on the run's final state and on a
    seeded developed state (20 launches each on CUDA events), GB/s at 233
    B/site against P1.  The bound: 233 B/site, or the FP32 work of the
    duct's colliding sites (``site_ops``: a fluid site's under the id, from
    phase_build) where that is longer.  Returns each record entry's
    instances and the runs' launches."""
    import torch

    from tnl_lbm_tpu_torch.ops.boundary import collision_mask_codes
    from torch_cases import COLLISION_CASES, COLLISION_IDS

    t0 = time.perf_counter()
    err = {}
    for cid, eq in COLLISION_CASES:
        d = collision_compare(cid, eq)
        for name, (df, dr, du) in d.items():
            log("collisions", kernel=name, collision=cid, eq=eq or "natural", box="24x20x150",
                max_df=f"{df:.3e}", max_drho=f"{dr:.3e}", max_du=f"{du:.3e}")
            if df > TOL_F or dr > TOL_RHO or du > TOL_U:
                raise RuntimeError(f"{name} under {cid} ({eq or 'natural'}) disagrees with its "
                                   f"plain version: {d[name]}")
            err[(name, cid)] = max(err.get((name, cid), 0.0), df)
    instances = {key: [] for key in COLLISION_KERNELS}
    launches = {key: 0 for key in COLLISION_KERNELS}
    force = (FORCE_BENCH, 0.0, 0.0)
    for cid in COLLISION_IDS:
        for streaming in ("AB", "AA"):
            sim = collision_sim(cid, streaming)
            if sim.cfg.high_precision_rho:
                raise RuntimeError("site_ops counts the plain density sum; the run takes Neumaier's")
            colliding = float(np.isin(sim.domain.map, sorted(collision_mask_codes(3))).mean())
            work = tuple(v * colliding for v in site_ops[cid])
            counted = report_main(sim, f"{cid}_{streaming}")
            ms_step, mlups, _ = run_figures(sim)
            step = sim._step
            spare = torch.empty_like(sim.f)
            if streaming == "AB":
                if counted["ab"] != COLLISION_STEPS:
                    raise RuntimeError(f"{cid} A-B did not run every step through B4: {counted}")
                launches["ab_step"] += counted["ab"]
                runs = {"ab_step": lambda f: step(f, NU, force=force, out=spare)}
            else:
                half = COLLISION_STEPS // 2
                if (counted != {"even": half, "odd": COLLISION_STEPS - half, "pair": 0}
                        or sim.pair_dispatch is not False or sim._pair is not None):
                    raise RuntimeError(f"{cid} A-A did not run per step through B2/B3: "
                                       f"{counted}, pair_dispatch={sim.pair_dispatch}")
                launches["aa_even"] += counted["even"]
                launches["aa_odd"] += counted["odd"]
                runs = {"aa_even": lambda f: step(f, NU, force=force, parity=0),
                        "aa_odd": lambda f: step(f, NU, force=force, parity=1, out=spare)}
            # the run's final state (near rest after 100 steps) and a seeded developed
            # one (rho 1 +- 0.01, |u| ~ 0.02): KBC's time depends on the data
            developed = developed_f(sim.cfg)
            timed = {key: (time_ms(lambda: fn(sim.f), 20), time_ms(lambda: fn(developed), 20))
                     for key, fn in runs.items()}
            for key, (ms, ms_developed) in timed.items():
                name = f"{COLLISION_KERNELS[key]}_{collision_tag(cid)}_kernel"
                r = res[name]
                bound_ms, bound_by = bound(AB_BYTES, work)
                entry = {"id": cid, "kernel": name, "ms": ms, "ms_developed": ms_developed,
                         "mlups": mlups,
                         "registers": r["registers"], "spill_bytes": r.get("spill_stores", 0),
                         "max_abs_err": err[(key, cid)], "bound_ms": bound_ms,
                         "bound_by": bound_by}
                instances[key].append(entry)
                log("collisions", kernel=key, collision=cid, shape="256^3", ms=f"{ms:.4f}",
                    ms_developed=f"{ms_developed:.4f}", gbps=f"{gbps(AB_BYTES, ms):.1f}",
                    share_of_p1=f"{gbps(AB_BYTES, ms) / floor_gbps:.3f}",
                    bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                    fluid_site_fp32_slots=site_ops[cid][0], fluid_site_mufu=site_ops[cid][1],
                    colliding_share=f"{colliding:.6f}",
                    fp32_slots_per_thread=ops[name][0], mufu_per_thread=ops[name][1],
                    registers=r["registers"], spill_stores=r.get("spill_stores", 0),
                    run_mlups=f"{mlups:.1f}", run_ms_per_step=f"{ms_step:.4f}")
            del sim, step, spare, developed
            torch.cuda.empty_cache()
    log("collisions", seconds=f"{time.perf_counter() - t0:.1f}", runs=2 * len(COLLISION_IDS),
        **{f"launches_{k}": v for k, v in launches.items()}, card=card_state())
    return {"instances": instances, "launches": launches,
            "err": {key: max(e for (k, _), e in err.items() if k == key)
                    for key in COLLISION_KERNELS}}


#: the record entries of the kernels whose family instances (csrc/coll_*.cu's
#: force_field kernels, csrc/nn_coll_*.cu, csrc/pair_coll_*.cu) phase
#: ``collision_routes`` holds and times, with their instances' name patterns
ROUTE_KERNELS = {"ab_step_force_field": "ab_step_{tag}_ff_kernel",
                 "aa_even_force_field": "aa_even_{tag}_ff_kernel",
                 "aa_odd_force_field": "aa_odd_{tag}_ff_kernel",
                 "nn_step_ab": "nn_step_ab_{tag}_kernel", "nn_step_even": "nn_step_even_{tag}_kernel",
                 "nn_step_odd": "nn_step_odd_{tag}_kernel", "aa_pair_full": "aa_pair_full_{tag}_kernel"}
#: the step's instances of CUM's family row (its eq_entropic instance; the
#: other rows' are phase ``collisions``')
ROUTE_LEAN_KERNELS = {"ab_step": "ab_step_{tag}_kernel", "aa_even": "aa_even_{tag}_kernel",
                      "aa_odd": "aa_odd_{tag}_kernel"}
#: the family rows: the per-step collisions' tags and CUM's row with the
#: equilibrium read at run time (its eq_entropic instance)
ROUTE_TAGS = COLLISION_TAGS + ("cum",)
ROUTE_KERNEL_NAMES = tuple(pattern.format(tag=t) for t in ROUTE_TAGS
                           for pattern in ROUTE_KERNELS.values()) + tuple(
    f"{p}_cum_kernel" for p in ("ab_step", "aa_even", "aa_odd"))
#: the collisions of the full-width runs through the hooked routes, pair
#: dispatch and the IBM: the LES and the entropic operators (for turbulent
#: flow), and the SRT forcing that reads the collision's total force
ROUTE_IDS = ("MRT_LES", "KBC_N1", "SRT_MODIF_FORCE")
ROUTE_STEPS = 100  # steps of each full-width run
IBM_ROUTE_STEPS = 20  # steps of the IBM run under MRT_LES at sim_ibm res 1's lattice
#: the peak u_x of the hooked duct's start: a duct profile, whose shear gives
#: the hook's force from the first step
ROUTE_PROFILE_U = 0.05
#: the factor on TOL_APP of a KBC run held to its plain run: the repo's KBC
#: bounds are ten times the others (tests/torch_cases.py KBC_TOL_F over
#: KERNEL_TOL_F).  Over 100 steps from the duct profile the per-step A-B
#: kernel's KBC instance drifts from its plain run as the hooked routes do,
#: linearly, ~1e-7 in rho a step at a step's own agreement of <= 4.8e-7
#: (PERF.md §6, collision routes)
ROUTE_KBC_FACTOR = 10


def route_cases() -> tuple:
    """(id, equilibrium id or None) of the family instances' compares: the
    per-step compares' cases and CUM with the entropic equilibrium."""
    from torch_cases import COLLISION_CASES

    return tuple(COLLISION_CASES) + (("CUM", "EQ_ENTROPIC"),)


def route_compares() -> dict:
    """Each family instance of the force_field steps, B10 and B1b against its
    plain version on the card, from the same input on both sides, at the step
    bounds (|df| <= 1e-6, KBC too; |drho| <= 2e-6; |du| <= 1e-6):

    - B4's force_field instance on ``bc_box(COLLISION_BOX)`` (one A-B step),
      B2's then B3's on ``aa_box`` (even, then odd from its output), with a
      seeded per-site force of ~1e-5 plus a homogeneous one (``force_add``);
      for CUM with eq_entropic the step's instances first, the same way with
      a body force;
    - B10, A-B, even and odd, on ``nn_case("duct")`` with CY(0.1, 1, 2, 0.5)
      wrapped as the domain and a body force;
    - B1b, one pair on ``aa_box`` with a body force and an inflow velocity, at
      a shape whose x spans several of the kernel's segments.

    Returns {record key: max |df|} over the cases."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa, make_fused_step_aa
    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
    from torch_cases import NN_MODELS, U_IN, aa_box, bc_box, collision_spec, collision_state, nn_case

    force = (1e-5, -2e-6, 3e-6)
    field = seeded_field((3,) + COLLISION_BOX, seed=31)
    nm, nper, model, hper = nn_case("duct")
    err = {}

    def check(key, cid, eq, k, p, where):
        torch.cuda.synchronize()
        d = tuple(max_diff(a, b) for a, b in zip(k, p))
        log("collision_routes", kernel=key, collision=cid, eq=eq or "natural", where=where,
            max_df=f"{d[0]:.3e}", max_drho=f"{d[1]:.3e}", max_du=f"{d[2]:.3e}")
        if d[0] > TOL_F or d[1] > TOL_RHO or d[2] > TOL_U:
            raise RuntimeError(f"{key} under {cid} ({eq or 'natural'}) disagrees with its plain "
                               f"version on {where}: {d}")
        err[key] = max(err.get(key, 0.0), d[0])

    for cid, eq in route_cases():
        for streaming, m in (("AB", bc_box(COLLISION_BOX)), ("AA", aa_box(COLLISION_BOX))):
            cfg = interop.config_from_spec(**collision_spec(cid, streaming, eq))
            dom = interop.domain_from_numpy(m, (False, False, True))
            f = collision_state(cfg, COLLISION_BOX, DEVICE)
            box = "x".join(map(str, COLLISION_BOX))
            parities = (0,) if streaming == "AB" else (0, 1)
            if cid == "CUM":  # the family's CUM row in the step's mode too
                lean = (make_fused_step if streaming == "AB" else make_fused_step_aa)(
                    cfg, dom, DEVICE)
                g = f
                for parity in parities:
                    key = ("ab_step", "aa_even", "aa_odd")[parity + (streaming == "AA")]
                    p = lean.plain(g, NU, u_in=U_IN, force=force, parity=parity)
                    k = lean(g.clone() if parity == 0 else g, NU, u_in=U_IN, force=force,
                             parity=parity)
                    check(key, cid, eq, k, p, box)
                    g = k[0]
            ff = (make_fused_step if streaming == "AB" else make_fused_step_aa)(
                cfg, dom, DEVICE, force_field=True)
            if ff._instance[0] == "cum":
                raise RuntimeError(f"{cid} took a cumulant instance: {ff._instance}")
            kw = dict(u_in=U_IN, force=field, force_add=force)
            for parity in parities:
                key = ("ab_step", "aa_even", "aa_odd")[parity + (streaming == "AA")]
                p = ff.plain(f, NU, parity=parity, **kw)
                k = ff(f.clone() if parity == 0 else f, NU, parity=parity, **kw)
                check(f"{key}_force_field", cid, eq, k, p, box)
                f = k[0]
            if streaming == "AA":
                pair = make_fused_pair_aa(cfg, dom, DEVICE)
                segments = pair.geometry()["segments"]
                if segments < 2:
                    raise RuntimeError(f"B1b's compare box spans {segments} x segment")
                f = collision_state(cfg, COLLISION_BOX, DEVICE)
                check("aa_pair_full", cid, eq, pair(f, NU, u_in=U_IN, force=force),
                      pair.plain(f, NU, u_in=U_IN, force=force), f"{box} ({segments} segments)")
            ncfg = hooked_cfg(interop.config_from_spec(**collision_spec(cid, streaming, eq)),
                              model, hper)
            nstep = make_fused_nn_step(ncfg, interop.domain_from_numpy(nm, nper), NN_MODELS[model],
                                       hper, DEVICE)
            fn = collision_state(ncfg, nm.shape, DEVICE)
            for parity in ((0,) if streaming == "AB" else (0, 1)):
                key = ("nn_step_ab", "nn_step_even", "nn_step_odd")[parity + (streaming == "AA")]
                check(key, cid, eq, nstep(fn, NU, force=force, parity=parity),
                      nstep.plain(fn, NU, force=force, parity=parity),
                      "x".join(map(str, nm.shape)) + " duct")
    return err


def route_timings(floor_gbps: float, res: dict, site_ops: dict, err: dict) -> dict:
    """Each family instance of the force_field steps, B10 and B1b at 256^3 on
    the bench duct (the hooked one for B10: CY(0.1, 1, 2, 0.5) wrapped as the
    domain), on a seeded developed state (rho 1 +- 0.01, |u| ~ 0.02), 20
    launches on CUDA events each; GB/s against P1; the bound: 245 B/site
    with the field, 233 B/site for B10 and B1b (a pair), or the FP32 slots
    of the duct's colliding sites under the id (``site_ops``, twice for a
    pair) where those take longer; registers and spills.  CUM with
    eq_entropic also through the step's instances (233 B/site).  Returns
    {record key: [instance entries]}."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa, make_fused_step_aa
    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
    from tnl_lbm_tpu_torch.ops.boundary import collision_mask_codes
    from torch_cases import COLLISION_IDS, NN_MODELS, collision_spec

    field = seeded_field((3,) + BENCH_SHAPE, seed=33)
    fb = np.array([FORCE_BENCH, 0.0, 0.0], np.float32)
    instances = {key: [] for key in {**ROUTE_KERNELS, **ROUTE_LEAN_KERNELS}}
    dom = flagship(BENCH_SHAPE)[1]  # the domain of both patterns
    colliding = float(np.isin(dom.map, sorted(collision_mask_codes(3))).mean())
    for cid, eq in tuple((c, None) for c in COLLISION_IDS) + (("CUM", "EQ_ENTROPIC"),):
        tag = collision_tag(cid)
        work = tuple(v * colliding for v in site_ops[cid]) if cid in site_ops else (0, 0)
        for streaming in ("AB", "AA"):
            cfg = interop.config_from_spec(**collision_spec(cid, streaming, eq))
            developed = developed_f(cfg)
            spare = torch.empty_like(developed)
            ff = (make_fused_step if streaming == "AB" else make_fused_step_aa)(
                cfg, dom, DEVICE, force_field=True)
            nstep = make_fused_nn_step(hooked_cfg(cfg, NN_BENCH_MODEL, dom.periodic), dom,
                                       NN_MODELS[NN_BENCH_MODEL], dom.periodic, DEVICE)
            kw = dict(force=field, force_add=fb)
            lean = (make_fused_step if streaming == "AB" else make_fused_step_aa)(
                cfg, dom, DEVICE) if cid == "CUM" else None
            if streaming == "AB":
                runs = {"ab_step_force_field": lambda: ff(developed, NU, out=spare, **kw),
                        "nn_step_ab": lambda: nstep(developed, NU, force=fb, out=spare)}
                if lean is not None:
                    runs["ab_step"] = lambda: lean(developed, NU, force=fb, out=spare)
            else:
                work_f = developed.clone()
                pair = make_fused_pair_aa(cfg, dom, DEVICE)
                runs = {"aa_even_force_field": lambda: ff(work_f, NU, parity=0, **kw),
                        "aa_odd_force_field": lambda: ff(developed, NU, parity=1, out=spare,
                                                         **kw),
                        "nn_step_even": lambda: nstep(developed, NU, force=fb, parity=0,
                                                      out=spare),
                        "nn_step_odd": lambda: nstep(developed, NU, force=fb, parity=1,
                                                     out=spare),
                        "aa_pair_full": lambda: pair(developed, NU, force=fb, out=spare)}
                if lean is not None:
                    runs["aa_even"] = lambda: lean(work_f, NU, force=fb, parity=0)
                    runs["aa_odd"] = lambda: lean(developed, NU, force=fb, parity=1, out=spare)
            for key, fn in runs.items():
                ms = time_ms(fn, 20)
                name = {**ROUTE_KERNELS, **ROUTE_LEAN_KERNELS}[key].format(tag=tag)
                r = res[name]
                bytes_site = FF_BYTES if key.endswith("force_field") else AB_BYTES
                ops_site = tuple(2 * v for v in work) if key == "aa_pair_full" else work
                bound_ms, bound_by = bound(bytes_site, ops_site)
                instances[key].append({
                    "id": cid, "eq": eq or "natural", "kernel": name, "ms": ms,
                    "registers": r["registers"], "spill_bytes": r.get("spill_stores", 0),
                    "max_abs_err": err[key], "bound_ms": bound_ms, "bound_by": bound_by})
                rate = gbps(bytes_site, ms)
                log("collision_routes", kernel=name, collision=cid, eq=eq or "natural",
                    shape="256^3", ms=f"{ms:.4f}", gbps=f"{rate:.1f}",
                    share_of_p1=f"{rate / floor_gbps:.3f}", bound_ms=f"{bound_ms:.4f}",
                    bound_by=bound_by, share_of_bound=f"{bound_ms / ms:.3f}",
                    registers=r["registers"], spill_stores=r.get("spill_stores", 0))
            del runs, ff, nstep, lean, developed, spare
            torch.cuda.empty_cache()
    return instances


def route_profile(cfg, shape):
    """The hooked duct's start: rho = 1 and a duct profile u_x =
    ROUTE_PROFILE_U * 16 y' (1 - y') z' (1 - z') over the y-z section
    (y', z' in [0, 1] across it), in cfg's equilibrium."""
    import torch

    X, Y, Z = shape
    y = torch.linspace(0.0, 1.0, Y, device=DEVICE).view(1, Y, 1)
    z = torch.linspace(0.0, 1.0, Z, device=DEVICE).view(1, 1, Z)
    ux = (ROUTE_PROFILE_U * 16.0 * y * (1 - y) * z * (1 - z)).expand(X, Y, Z)
    u = torch.stack([ux, torch.zeros_like(ux), torch.zeros_like(ux)])
    return cfg.eq(cfg.lat, torch.ones(shape, device=DEVICE), u).float().contiguous()


def route_hooked_sim(cid: str, streaming: str, route: str):
    """``Simulation`` on the hooked 256^3 bench duct (CY(0.1, 1, 2, 0.5)
    wrapped as the domain, scripts/bench_hooked.py:56-69) under ``cid``,
    ROUTE_STEPS steps from ``route_profile``, counted from the end of
    sim_init: ``route`` "plain" (the plain hooked step), "single_kernel"
    (B10) or "pipeline" (the same hook through the u* pass, B9 and the
    force_field step: ``single_kernel=False``)."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
    from tnl_lbm_tpu_torch.sim.state import Simulation
    from torch_cases import collision_spec

    class RouteDuct(Simulation):
        def body_force(self, phys_time):
            return np.array([FORCE_BENCH, 0.0, 0.0])

        def _build_step(self):
            super()._build_step()
            if route == "pipeline":
                self._step = make_hooked_fused_step(self.cfg, self.domain, self.device,
                                                    single_kernel=False)

        def sim_init(self):
            super().sim_init()
            self.f.copy_(route_profile(self.cfg, self.domain.shape))
            self._initial_macro()

    _, dom = flagship(BENCH_SHAPE, streaming=streaming)
    cfg = hooked_cfg(interop.config_from_spec(**collision_spec(cid, streaming)), NN_BENCH_MODEL,
                     dom.periodic)
    sim = counting_from_init(RouteDuct(
        cfg, dom, device=DEVICE, sim_id=f"route_{cid}_{streaming}_{route}",
        results_parent=WORK / "collision_routes", phys_final_time=ROUTE_STEPS * dom.units.phys_dt,
        steps_per_dispatch=10, use_fused=route != "plain"))
    sim.sample_phases_at_finish = False
    if not sim.run() or sim.iterations != ROUTE_STEPS:
        raise RuntimeError(f"hooked {cid} {streaming} {route} failed ({sim.iterations} steps)")
    torch.cuda.synchronize()
    return sim


def route_launches(streaming: str, route: str) -> dict:
    """The launches of ROUTE_STEPS hooked steps through a route: one B10
    launch a step, or one of each pipeline kernel a step (A-A: even and odd
    by halves)."""
    half = ROUTE_STEPS // 2
    if route == "single_kernel":
        return ({"nn_step_ab": ROUTE_STEPS} if streaming == "AB"
                else {"nn_step_even": half, "nn_step_odd": ROUTE_STEPS - half})
    if streaming == "AB":
        return {"ab_step_macro_only": ROUTE_STEPS, "nn_force": ROUTE_STEPS,
                "ab_step_force_field": ROUTE_STEPS}
    return {"aa_even_macro_only": half, "aa_odd_macro_only": ROUTE_STEPS - half,
            "nn_force": ROUTE_STEPS, "aa_even_force_field": half,
            "aa_odd_force_field": ROUTE_STEPS - half}


def route_runs() -> dict:
    """The full-width runs under ROUTE_IDS, each with its launch counts set
    to 0 at the end of sim_init and read after it:

    - the 256^3 bench duct, A-A, ``pair_dispatch="auto"``: the probe times
      the full-set pair (B1b) against per step and keeps the faster; its two
      times, its choice, the run's launches and MLUPS;
    - the hooked 256^3 duct, A-B and A-A: the plain hooked step, then B10
      and the pipeline (u* pass, B9, the force_field step) with the same
      hook, ROUTE_STEPS steps each from the same duct profile; f, rho and u
      of each kernel route within TOL_APP of the plain run's (the apps
      gate; KBC_N1 ROUTE_KBC_FACTOR times it), MLUPS, and each run's mean
      rho - 1;
    - sim_ibm res 1 under MRT_LES (the IBM through the u* pass and the
      force_field step), IBM_ROUTE_STEPS steps through the kernels and
      through the plain hooked step, CG pinned: rho and u within TOL_APP.

    Returns {"launches": {record key: n}, "by_id": {(id, record key): n},
    "auto": {id: (choice, pair ms, per-step ms, B1b launches, MLUPS)},
    "mlups": {label: MLUPS}}."""
    import torch

    launches, by_id, auto, mlups = {}, {}, {}, {}

    def add(key, n, cid):
        launches[key] = launches.get(key, 0) + n
        by_id[(cid, key)] = by_id.get((cid, key), 0) + n

    for cid in ROUTE_IDS:
        sim = collision_sim(cid, "AA", pair_dispatch="auto")
        counted = report_main(sim, f"auto_{cid}_AA")
        if sim.pair_probe_ms is None or sim.iterations != COLLISION_STEPS:
            raise RuntimeError(f"{cid} A-A auto did not time the pair: {counted}")
        chose = "pair" if sim.pair_dispatch else "per_step"
        half = COLLISION_STEPS // 2
        want = ({"even": 0, "odd": 0, "pair": half} if sim.pair_dispatch
                else {"even": half, "odd": half, "pair": 0})
        if counted != want or type(sim._pair).__name__ != "FusedPairAAFull":
            raise RuntimeError(f"{cid} A-A auto ({chose}) ran {counted} through "
                               f"{type(sim._pair).__name__}")
        auto_choice(sim, f"256^3 {cid}")
        ms_step, rate, _ = run_figures(sim)
        t_pair, t_steps = sim.pair_probe_ms
        auto[cid] = (chose, t_pair, t_steps, counted["pair"], rate)
        mlups[f"auto_{cid}_AA"] = rate
        log("collision_routes", path="auto", collision=cid, shape="256^3", chose=chose,
            probe_pair_ms=f"{t_pair:.4f}", probe_per_step_ms=f"{t_steps:.4f}",
            launches_pair=counted["pair"], launches_even=counted["even"],
            launches_odd=counted["odd"], mlups=f"{rate:.1f}", ms_per_step=f"{ms_step:.4f}")
        add("aa_pair_full", counted["pair"], cid)
        add("aa_even", counted["even"], cid)
        add("aa_odd", counted["odd"], cid)
        del sim
        torch.cuda.empty_cache()
    for cid in ROUTE_IDS:
        gate = TOL_APP * (ROUTE_KBC_FACTOR if cid.startswith("KBC") else 1)
        for streaming in ("AB", "AA"):
            plain = route_hooked_sim(cid, streaming, "plain")
            ref = (plain.f.clone(), plain.rho.clone(), plain.u.clone())
            mlups[f"hooked_{cid}_{streaming}_plain"] = run_figures(plain)[1]
            plain_mass = float(plain.rho.double().mean() - 1)
            del plain
            torch.cuda.empty_cache()
            for route in ("single_kernel", "pipeline"):
                sim = route_hooked_sim(cid, streaming, route)
                counted = report_main(sim, f"hooked_{cid}_{streaming}_{route}")
                ran = {k: v for k, v in counted.items() if v}
                if sim._step.route != route or ran != route_launches(streaming, route):
                    raise RuntimeError(f"hooked {cid} {streaming}: route {sim._step.route}, "
                                       f"launches {counted}")
                d = (max_diff(sim.f, ref[0]), max_diff(sim.rho, ref[1]), max_diff(sim.u, ref[2]))
                rate = run_figures(sim)[1]
                mlups[f"hooked_{cid}_{streaming}_{route}"] = rate
                log("collision_routes", path="hooked_duct", collision=cid, streaming=streaming,
                    route=route, shape="256^3", steps=sim.iterations, mlups=f"{rate:.1f}",
                    plain_mlups=f"{mlups[f'hooked_{cid}_{streaming}_plain']:.1f}",
                    max_df_vs_plain_run=f"{d[0]:.3e}", max_drho_vs_plain_run=f"{d[1]:.3e}",
                    max_du_vs_plain_run=f"{d[2]:.3e}", gate=gate,
                    mean_rho_minus_1=f"{float(sim.rho.double().mean() - 1):.3e}",
                    plain_mean_rho_minus_1=f"{plain_mass:.3e}",
                    **{f"launches_{k}": v for k, v in counted.items() if v})
                if max(d) > gate:
                    raise RuntimeError(f"hooked {cid} {streaming} {route} vs the plain run: {d}")
                for key, n in counted.items():
                    add(key, n, cid)
                del sim
                torch.cuda.empty_cache()
            del ref
            torch.cuda.empty_cache()
    kernel = ibm_sim(1, "route_mrt_les_kernel", IBM_ROUTE_STEPS, pinned=True, collision="MRT_LES")
    counted = report_main(kernel, "ibm_res1_MRT_LES")
    plain = ibm_sim(1, "route_mrt_les_plain", IBM_ROUTE_STEPS, use_fused=False, pinned=True,
                    collision="MRT_LES")
    d = (max_diff(kernel.rho, plain.rho), max_diff(kernel.u, plain.u))
    rate = run_figures(kernel)[1]
    mlups["ibm_res1_MRT_LES"] = rate
    log("collision_routes", path="sim_ibm_res1", collision="MRT_LES",
        shape="x".join(map(str, kernel.domain.shape)), steps=kernel.iterations,
        max_drho_vs_plain_run=f"{d[0]:.3e}", max_du_vs_plain_run=f"{d[1]:.3e}",
        mlups=f"{rate:.1f}", **{f"launches_{k}": v for k, v in counted.items() if v})
    if max(d) > TOL_APP or counted.get("ab_step_force_field") != IBM_ROUTE_STEPS:
        raise RuntimeError(f"sim_ibm res 1 under MRT_LES: kernel vs plain {d}, {counted}")
    if kernel._step.base._instance[0] == "cum":
        raise RuntimeError("sim_ibm under MRT_LES ran a cumulant instance")
    for key, n in counted.items():
        add(key, n, "MRT_LES")
    del kernel, plain
    torch.cuda.empty_cache()
    return {"launches": launches, "by_id": by_id, "auto": auto, "mlups": mlups}


def phase_collision_routes(floor_gbps: float, res: dict, site_ops: dict) -> dict:
    """The rest of the D3Q27 collision set on the force_field steps (B4,
    B2/B3; csrc/coll_*.cu), the one-kernel NN step (B10; csrc/nn_coll_*.cu)
    and the full-set pair (B1b; csrc/pair_coll_*.cu): ``route_compares``,
    ``route_timings`` and ``route_runs``.  Returns the record entries'
    instances, errors and launches."""
    t0 = time.perf_counter()
    err = route_compares()
    instances = route_timings(floor_gbps, res, site_ops, err)
    _DEVELOPED.clear()  # the last of the 256^3 timings on the developed state
    runs = route_runs()
    for key, entries in instances.items():  # each instance's launches on the main paths
        for e in entries:
            e["launches"] = runs["by_id"].get((e["id"], key), 0)
    log("collision_routes", seconds=f"{time.perf_counter() - t0:.1f}",
        **{f"launches_{k}": v for k, v in runs["launches"].items()}, card=card_state())
    runs.pop("by_id")
    return {"instances": instances, "err": err, **runs}


def two_kernel(sim):
    """Drop the coupled kernel at the end of ``sim_init``: ``_advance`` then
    runs the A-B step (B4) and the ADE step (B6) that ``sim_init`` built -
    the JAX package's "two-kernel" path, which the port's own rules never
    pick.  A subclass, as in ``counting_from_init``."""

    class TwoKernel(type(sim)):
        def sim_init(self):
            super().sim_init()
            self._coupled_step, self.coupled_kernel = None, "two-kernel"

    sim.__class__ = TwoKernel
    return sim


def coupled_main_path() -> dict:
    """sim_coupled at COUPLED_RES through its ``build`` with ``--use-fused``,
    APP_STEPS steps through the coupled kernel, then through the two-kernel
    path (B4 then B6), then with ``--streaming AA`` through the A-A coupled
    pair (B8), each counted from the end of sim_init."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_coupled
    from torch_cases import local_scale

    out, final, slabs, figures = {"kernels": {}, "err": {}}, None, {}, {}
    half = APP_STEPS // 2
    for dispatch in ("one-kernel-AB", "two-kernel", "one-kernel-AA"):
        label = f"sim_coupled_res{COUPLED_RES}_{dispatch}"
        streaming = "AA" if dispatch == "one-kernel-AA" else "AB"
        sim = sim_coupled.build(COUPLED_RES, device=DEVICE, use_fused=True, streaming=streaming,
                                results_parent=WORK / "main" / dispatch)
        if dispatch == "two-kernel":
            two_kernel(sim)
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        if not counting_from_init(sim).run():
            raise RuntimeError(f"{label} failed (NaN or refused)")
        launches = report_main(sim, label)
        figures[dispatch] = run_figures(sim)
        want = {"one-kernel-AB": {"coupled": APP_STEPS, "ab": 0, "ade": 0},
                "two-kernel": {"coupled": 0, "ab": APP_STEPS, "ade": APP_STEPS},
                "one-kernel-AA": {"even": 0, "odd": 0, "coupled_even": half,
                                  "coupled_odd": APP_STEPS - half}}[dispatch]
        if (sim.coupled_kernel != dispatch or launches != want
                or sim.iterations != APP_STEPS):
            raise RuntimeError(f"{label}: coupled_kernel {sim.coupled_kernel!r}, launches "
                               f"{launches} after {sim.iterations} steps")
        if streaming not in slabs:
            slabs[streaming] = plume_slab(sim)
        check_plume(sim, label, slabs[streaming])
        if dispatch == "one-kernel-AB":
            out["kernels"]["coupled_ab"] = dataclasses.replace(sim._coupled_step.kernel)
            out["err"]["coupled_ab"] = coupled_kernel_vs_plain_at(sim)
            final = (sim.rho.clone(), sim.u.clone(), sim.phi.clone())
            sim._spare, sim._g_spare = torch.empty_like(sim.f), torch.empty_like(sim.g)
        elif dispatch == "two-kernel":
            out["kernels"]["ade_step"] = dataclasses.replace(sim._ade_step.kernel)
            out["ab_launches"] = launches["ab"]
            same = all(torch.equal(a, b) for a, b in zip(final, (sim.rho, sim.u, sim.phi)))
            d = (max_diff(final[0], sim.rho), max_diff(final[1], sim.u),
                 scaled_diff(sim.phi, final[2], local_scale(final[2])))
            log("main", path=label, compare="two-kernel vs one-kernel final fields",
                max_drho=d[0], max_du=d[1], max_dphi_scaled=d[2], bit_equal=same)
            if not (d[0] <= TOL_APP and d[1] <= TOL_APP and d[2] <= TOL_APP):
                raise RuntimeError(f"{label}: the two coupled paths disagree: {d}")
        else:
            for parity in ("even", "odd"):
                out["kernels"][f"coupled_aa_{parity}"] = dataclasses.replace(
                    getattr(sim._coupled_step, parity))
            out["err"].update(coupled_aa_kernel_vs_plain_at(sim))
            ab, aa = figures["one-kernel-AB"], figures[dispatch]
            log("main", path=label, beside="one-kernel-AB of this call",
                ms_per_step_aa=f"{aa[0]:.4f}", ms_per_step_ab=f"{ab[0]:.4f}",
                mlups_aa=f"{aa[1]:.1f}", mlups_ab=f"{ab[1]:.1f}", peak_gb_aa=f"{aa[2]:.3f}",
                peak_gb_ab=f"{ab[2]:.3f}", aa_over_ab_time=f"{aa[0] / ab[0]:.3f}")
            sim._spare, sim._g_spare = torch.empty_like(sim.f), torch.empty_like(sim.g)
        profile_loop(sim, label)
        del sim
        torch.cuda.empty_cache()
    return out


def plume_slab(sim):
    """The reference of sim_coupled's middle: the same units, collisions,
    streaming, inflow and outflow (A-A: OUTFLOW_RIGHT for the A-B-only
    OUTFLOW_PE, as the app) on an X x 4 x 4 slab periodic in y and z,
    APP_STEPS plain steps on the card.  A site more than APP_STEPS sites
    from the walls takes, in APP_STEPS steps, only what the slab's sites
    take."""
    from tnl_lbm_tpu_torch.apps.sim_coupled import SimCoupled
    from tnl_lbm_tpu_torch.models import D3Q7, D3Q27
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from tnl_lbm_tpu_torch.sim.config import Domain
    from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO
    from tnl_lbm_tpu_torch.utils.units import Lattice

    X = sim.domain.shape[0]
    u0 = sim.domain.units
    units = Lattice(global_size=(X, 4, 4), phys_origin=(0.0, 0.0, 0.0), phys_dl=u0.phys_dl,
                    phys_dt=u0.phys_dt, phys_viscosity=u0.phys_viscosity)
    m = np.zeros((X, 4, 4), np.uint8)
    m[0], m[-1] = GEO.INFLOW, GEO.OUTFLOW_EQ
    ma = np.zeros((X, 4, 4), np.uint8)
    streaming = sim.ade_cfg.streaming
    ma[0], ma[-1] = ADEGEO.INFLOW, ADEGEO.OUTFLOW_RIGHT if streaming == "AA" else ADEGEO.OUTFLOW_PE
    per = (False, True, True)
    slab = SimCoupled(sim.cfg, Domain(lat=D3Q27, units=units, map=m, periodic=per), sim.ade_cfg,
                      Domain(lat=D3Q7, units=units, map=ma, periodic=per),
                      ade_diffusion=sim.ade_diffusion, phi_inflow=sim.phi_inflow, device=DEVICE,
                      sim_id=f"plume_slab_{streaming}", results_parent=WORK / "main" / "slab",
                      phys_final_time=APP_STEPS * units.phys_dt, use_fused=False)
    slab.lbm_inflow_vx = sim.lbm_inflow_vx
    if not slab.run() or slab.iterations != APP_STEPS or slab.coupled_kernel != "plain":
        raise RuntimeError("the plume slab reference failed")
    return slab


def profile_loop(sim, label: str, steps: int = 10) -> None:
    """Where the time of a Simulation's loop goes: after 5 warm-up steps,
    ``steps`` steps unprofiled (host clock, ending in a synchronize), then
    ``steps`` under torch.profiler - device time per kernel, and the share
    of the profiled host time the device was busy.  The kernel events the
    profiler recorded are printed beside the launches the wrappers counted
    in the window: where it recorded fewer, its device time and busy share
    read low.  Runs past the checked state; a run's own checks come first."""
    from torch.profiler import ProfilerActivity, profile

    sim._advance(5)
    t0 = time.perf_counter()
    sim._advance(steps)
    unprofiled = (time.perf_counter() - t0) * 1e3
    launched = sum(kernel_launches(sim).values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim._advance(steps)
        wall = (time.perf_counter() - t0) * 1e3
    launched = sum(kernel_launches(sim).values()) - launched
    device, count = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            device[e.key], count[e.key] = us / 1e3, e.count
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
    log("profile", path=label, steps=steps, unprofiled_ms_per_step=f"{unprofiled / steps:.4f}",
        profiled_ms_per_step=f"{wall / steps:.4f}", device_ms_per_step=f"{busy / steps:.4f}",
        device_busy_share=f"{busy / wall:.4f}" if wall else "n/a",
        kernel_events=sum(count[k] for k in count if k.endswith("_kernel")),
        launches_in_window=launched,
        **{f"device_ms_{k[:40]}": f"{v / steps:.4f}" for k, v in top})


def check_plume(sim, label: str, slab) -> None:
    """phi finite everywhere.  On the y band more than WALL_REACH sites from
    the WALL_BODY walls (whose anti-bounce-back grows phi; a site moves
    information one site per step), rho, u and phi equal, within TOL_APP,
    the plain steps' on a periodic slab (``plume_slab``), phi <= 1 + 1e-3,
    and phi has risen above zero at x = 1.  The step front at the inlet
    undershoots below zero (CLBM at omega 1.92); its minimum is printed."""
    import torch

    Y, Z = sim.ade_domain.shape[1:]
    band = sim.phi[:, WALL_REACH + 1 : Y - WALL_REACH - 1]
    lo, hi = float(band.min()), float(band.max())
    inlet = float(band[1].max())
    finite = bool(torch.isfinite(sim.phi).all())
    mid = (slice(None), Y // 2, Z // 2)
    d = (max_diff(sim.rho[mid], slab.rho[:, 0, 0]), max_diff(sim.u[(slice(None),) + mid],
                                                             slab.u[:, :, 0, 0]),
         max_diff(sim.phi[mid], slab.phi[:, 0, 0]))
    spread = max_diff(band, band[:, :1].expand_as(band))
    log("main", path=label, phi_finite=finite, max_abs_phi=float(sim.phi.abs().max()),
        band_y=f"{WALL_REACH + 1}..{Y - WALL_REACH - 2}", band_phi_min=lo, band_phi_max=hi,
        band_phi_max_x1=inlet, band_spread_in_y=spread, slab_max_drho=d[0], slab_max_du=d[1],
        slab_max_dphi=d[2], max_abs_u=float(sim.u.abs().max()))
    if not (finite and hi <= 1 + 1e-3 and inlet > 0 and all(x <= TOL_APP for x in d)):
        raise RuntimeError(f"{label}: phi not finite, out of range on the band, or the band "
                           f"differs from the slab reference: {d}")


def coupled_kernel_vs_plain_at(sim) -> float:
    """One coupled step from the main path's final state: a fresh coupled
    kernel wrapper against its plain version on the card; f, rho, u to the
    step bounds, g and phi relative to ``local_scale`` of the state (the
    walls have grown phi).  The spare buffers are freed first; the plain version's
    peak memory is reported.  Returns max |df|."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step
    from torch_cases import local_scale

    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    nu, phi_in = sim.domain.units.lbm_viscosity(), float(sim.phi_inflow)
    sim._spare = sim._g_spare = None
    torch.cuda.empty_cache()
    step = make_fused_coupled_step(sim.cfg, sim.domain, sim.ade_cfg, sim.ade_domain, DEVICE)
    k = step(sim.f, sim.g, nu, sim._nu_ade, u_in=u_in, force=force, phi_in=phi_in)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p = step.plain(sim.f, sim.g, nu, sim._nu_ade, u_in=u_in, force=force, phi_in=phi_in)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    scale = local_scale(sim.g)
    d = (max_diff(k[0], p[0]), max_diff(k[2], p[2]), max_diff(k[3], p[3]),
         scaled_diff(k[1], p[1], scale), scaled_diff(k[4], p[4], scale))
    log("main", path=f"sim_coupled_res{COUPLED_RES}", compare="kernel vs plain, one step from "
        "the final state", shape="x".join(map(str, sim.domain.shape)), max_df=d[0],
        max_drho=d[1], max_du=d[2], max_dg_scaled=d[3], max_dphi_scaled=d[4],
        plain_peak_gb=f"{plain_peak / 1e9:.3f}",
        plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}")
    del k, p
    torch.cuda.empty_cache()
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U and d[3] <= TOL_G
            and d[4] <= TOL_PHI):
        raise RuntimeError(f"coupled_ab vs plain on sim_coupled res {COUPLED_RES}: {d}")
    return d[0]


def coupled_aa_kernel_vs_plain_at(sim) -> dict:
    """From the A-A main path's final state (an even parity next), one even
    and then one odd parity of a fresh B8 wrapper against its plain version
    on the card, each from the same input on both sides: f, rho, u to the
    step bounds, g and phi relative to ``local_scale`` of the input g.  The
    spare buffers are freed first; the plain versions' peak memory is
    reported.  Returns max(|df|, |dg|) per kernel."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa
    from torch_cases import local_scale

    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    nu, phi_in = sim.domain.units.lbm_viscosity(), float(sim.phi_inflow)
    sim._spare = sim._g_spare = None
    torch.cuda.empty_cache()
    step = make_fused_coupled_step_aa(sim.cfg, sim.domain, sim.ade_cfg, sim.ade_domain, DEVICE)
    f, g, err = sim.f, sim.g, {}
    for parity, name in ((sim.iterations % 2, "coupled_aa_even"),
                         (1 - sim.iterations % 2, "coupled_aa_odd")):
        args = dict(u_in=u_in, force=force, phi_in=phi_in, parity=parity)
        k = step(f.clone(), g.clone(), nu, sim._nu_ade, **args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        p = step.plain(f, g, nu, sim._nu_ade, **args)
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        scale = local_scale(g)
        d = (max_diff(k[0], p[0]), max_diff(k[2], p[2]), max_diff(k[3], p[3]),
             scaled_diff(k[1], p[1], scale), scaled_diff(k[4], p[4], scale))
        log("main", path=f"sim_coupled_res{COUPLED_RES}_AA", compare="kernel vs plain, from "
            "the final state", kernel=name, shape="x".join(map(str, sim.domain.shape)),
            max_df=d[0], max_drho=d[1], max_du=d[2], max_dg_scaled=d[3], max_dphi_scaled=d[4],
            plain_peak_gb=f"{plain_peak / 1e9:.3f}",
            plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}")
        del p, scale
        torch.cuda.empty_cache()
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U and d[3] <= TOL_G
                and d[4] <= TOL_PHI):
            raise RuntimeError(f"{name} vs plain on sim_coupled res {COUPLED_RES}: {d}")
        err[name] = max(d[0], d[3])
        f, g = k[0], k[1]
        del k
    return err


def sim1_main_path(streaming: str = "AB", resolution: int = SIM1_RES, counted: bool = True):
    """sim_1 at ``resolution`` through its ``build`` with ``streaming`` (A-B:
    the A-B kernel; A-A: the even and odd kernels, pair dispatch off; the
    paired run is ``sim1_aa_dispatch``'s), APP_STEPS steps with
    its own probes (VTK3D, the whole lattice, is switched off: one cycle is
    1.1 GB of files at res 8), then one more VTK2D cycle from the final
    state, read back and held against the fields on the card."""
    from tnl_lbm_tpu_torch.apps import sim_1
    from tnl_lbm_tpu_torch.sim.state import VTK3D

    where = WORK / "main" if streaming == "AB" else WORK / "main" / f"sim_1_{streaming}"
    sim = sim_1.build(resolution, device=DEVICE, streaming=streaming, pair_dispatch=False,
                      results_parent=where / f"res{resolution}")
    sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
    sim.cnt[VTK3D].period = -1.0
    if counted:
        counting_from_init(sim)
    if not sim.run():
        raise RuntimeError(f"sim_1 res {resolution} {streaming} failed (NaN or refused)")
    sim._write_vtk_2d()
    for p in sim.probes_2d:
        got = read_vti(sim.results_dir / "vtk2D" / f"{p.name}_{p.cycle - 1:06d}.vti")
        sl = [slice(None)] * 3
        sl[p.axis] = slice(p.position, p.position + 1)
        scalars, vectors = sim.output_data(tuple(sl))
        want_rho = scalars["lbm_density"].cpu().numpy()
        want_u = vectors["velocity"].cpu().numpy()
        if not (np.array_equal(got["lbm_density"], want_rho)
                and np.array_equal(got["velocity"], want_u)):
            raise RuntimeError(f"sim_1 VTK2D cut {p.name} read back differs from the card's")
        log("main", path=f"sim_1_res{resolution}_{streaming}", vtk2d=p.name, cycles=p.cycle,
            read_back="equal", plane="x".join(map(str, want_rho.shape)))
    return sim


def sim1_aa_kernel_vs_plain(resolution: int = SIM1_AA_PLAIN_RES) -> dict:
    """sim_1 with A-A streaming at ``resolution``, APP_STEPS steps through
    the even and odd kernels, then from its final state one even and then
    one odd step of a fresh A-A step wrapper against its plain version on
    the card, each from the same input, with the step bounds.  At res 8 the
    plain A-A step's whole-array temporaries would not fit beside the run
    (the plain A-B step peaked at 73.3 GB there), so this runs at res 4.
    Returns max |df| per kernel."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

    sim = sim1_main_path("AA", resolution, counted=False)
    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    f, nu = sim.f, sim.domain.units.lbm_viscosity()
    step = make_fused_step_aa(sim.cfg, sim.domain, DEVICE)
    err = {}
    for parity, name in ((sim.iterations % 2, "aa_even"), (1 - sim.iterations % 2, "aa_odd")):
        fk, rk, uk = step(f.clone(), nu, u_in=u_in, force=force, parity=parity)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fp, rp, up = step.plain(f, nu, u_in=u_in, force=force, parity=parity)
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        log("main", path=f"sim_1_res{resolution}_AA", compare="kernel vs plain, from the final "
            f"state (res {resolution})", kernel=name, shape="x".join(map(str, sim.domain.shape)),
            max_df=d[0], max_drho=d[1], max_du=d[2], plain_peak_gb=f"{plain_peak / 1e9:.3f}",
            plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}", variant=step.variant)
        del fp, rp, up
        torch.cuda.empty_cache()
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"{name} vs plain on sim_1 res {resolution} A-A: {d}")
        err[name], f = d[0], fk
    return err


def sim1_kernel_vs_plain(sim) -> float:
    """One A-B step of sim_1 at SIM1_RES from the main path's final state:
    a fresh A-B kernel wrapper against its plain version on the card, with
    the step bounds.  The run's spare state buffer and macro fields are
    freed first; the plain version's peak memory is reported.  Returns
    max |df|."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    f, nu = sim.f, sim.domain.units.lbm_viscosity()
    sim._spare = sim.rho = sim.u = None
    torch.cuda.empty_cache()
    step = make_fused_step(sim.cfg, sim.domain, DEVICE)
    fk, rk, uk = step(f, nu, u_in=u_in, force=force)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fp, rp, up = step.plain(f, nu, u_in=u_in, force=force)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    log("main", path=f"sim_1_res{SIM1_RES}", compare="kernel vs plain, one step from the "
        "final state", shape="x".join(map(str, sim.domain.shape)), max_df=d[0], max_drho=d[1],
        max_du=d[2], plain_peak_gb=f"{plain_peak / 1e9:.3f}",
        plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}")
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"ab_step vs plain on sim_1 res {SIM1_RES} out of tolerance: {d}")
    return d[0]


def startup_l1(sim, iterations: int) -> float:
    from tnl_lbm_tpu_torch.apps import sim_2

    X, Y, Z = sim.domain.shape
    u0 = sim_2.duct_startup_ux(Y, Z, sim.fx_lbm, sim.domain.units.lbm_viscosity(),
                               iterations, wall_sites=2)
    return sim_2.duct_errors(np.broadcast_to(u0, (X, Y, Z)), sim.analytical, sim.domain.units)[0]


def run_sim2(label: str, args: list):
    from tnl_lbm_tpu_torch.apps import sim_2

    t0 = time.perf_counter()
    sim = sim_2.main(["2", "--device", DEVICE, *args, "--results-dir", str(WORK / label)])
    return sim, time.perf_counter() - t0


def phase_accuracy() -> dict:
    """sim_2 res 2 to its end per step, in pairs (f32, f16, bf16) and A-B,
    held to the start-up solution; the apps' kernel-vs-plain runs.  Returns
    the f32 per-step and A-B runs' L1 by iteration, which the float64 runs
    of ``phase_double_and_profile`` print beside theirs."""
    checked = {}
    for label, args in (("per_step", ["--streaming", "AA", "--use-fused", "--pair-dispatch", "off"]),
                        ("pair_f32", ["--streaming", "AA", "--use-fused", "--pair-dispatch", "on"])):
        sim, wall = run_sim2(label, args)
        it, l1, l2 = sim.error_history[-1]  # the last probe
        l1_ref = startup_l1(sim, it)
        rel = abs(l1 / l1_ref - 1)
        kernel = sim._pair.kernel if sim.pair_dispatch else sim._step.odd
        plain = sim._step.plain_calls + (sim._pair.plain_calls if sim._pair else 0)
        log("accuracy", path=label, l1=f"{l1:.6e}", l2=f"{l2:.6e}", iterations=it,
            stop=sim.terminate_reason or "final_time", wall_s=f"{wall:.1f}",
            l1_startup_solution=f"{l1_ref:.6e}", rel_to_startup=f"{rel:.2e}",
            l1_jax_recorded=L1_JAX_RECORDED, launches=kernel.launches, plain_calls=plain)
        if sim.nan_detected or not rel <= 0.05 or plain or kernel.launches <= 0:
            raise RuntimeError(f"sim_2 res 2 ({label}): L1 {l1:e} not within 5% of the "
                               f"start-up solution's {l1_ref:e}")
        checked[label] = sim
    f32 = {it: l1 for it, l1, _ in checked["pair_f32"].error_history}
    for store in ("f16", "bf16"):
        sim, wall = run_sim2(f"pair_{store}", ["--storage", store])
        it, l1, l2 = sim.error_history[-1]  # the last probe; the f32 run probed there too
        log("accuracy", path=f"pair_{store}", l1=f"{l1:.6e}", l2=f"{l2:.6e}", iterations=it,
            stop=sim.terminate_reason or "final_time", wall_s=f"{wall:.1f}",
            l1_f32_same_iteration=f"{f32[it]:.6e}" if it in f32 else "not probed",
            l1_over_f32=f"{l1 / f32[it]:.4f}" if it in f32 else "n/a",
            launches=sim._pair.kernel.launches, plain_calls=sim._pair.plain_calls)
        if sim.nan_detected or not np.isfinite([l1, l2]).all() or it not in f32:
            raise RuntimeError(f"sim_2 res 2 --storage {store}: non-finite L1/L2 or no f32 "
                               f"figure at iteration {it}")

    per_step = {it: l1 for it, l1, _ in checked["per_step"].error_history}
    sim, wall = run_sim2("ab_step", ["--streaming", "AB", "--use-fused"])
    it, l1, l2 = sim.error_history[-1]
    l1_ref = startup_l1(sim, it)
    rel = abs(l1 / l1_ref - 1)
    log("accuracy", path="ab_step", l1=f"{l1:.6e}", l2=f"{l2:.6e}", iterations=it,
        stop=sim.terminate_reason or "final_time", wall_s=f"{wall:.1f}",
        l1_startup_solution=f"{l1_ref:.6e}", rel_to_startup=f"{rel:.2e}",
        l1_aa_per_step_same_iteration=f"{per_step[it]:.6e}" if it in per_step else "not probed",
        launches=sim._step.kernel.launches, plain_calls=sim._step.plain_calls)
    if (sim.nan_detected or not rel <= 0.05 or sim._step.plain_calls
            or sim._step.kernel.launches <= 0):
        raise RuntimeError(f"sim_2 res 2 A-B: L1 {l1:e} not within 5% of the start-up "
                           f"solution's {l1_ref:e}")
    ab = {it: l1 for it, l1, _ in sim.error_history}
    del sim, checked
    for app, streaming in (("sim_1", "AB"), ("sim_3", "AB"), ("sim_1", "AA")):
        app_kernel_vs_plain(app, streaming)
    for streaming in ("AB", "AA"):
        coupled_app_kernel_vs_plain(streaming)
    return {"per_step": per_step, "ab_step": ab}


def coupled_app_kernel_vs_plain(streaming: str) -> None:
    """sim_coupled at resolution 2 with ``streaming``, APP_STEPS steps
    through the coupled kernel (B7; A-A: B8) and through the plain steps on
    the card, from the same start; phi is held relative to ``local_scale``
    of the plain run's phi, since the A-B walls grow it."""
    from tnl_lbm_tpu_torch.apps import sim_coupled
    from torch_cases import local_scale

    runs = {}
    for fused in (True, False):
        sim = sim_coupled.build(2, device=DEVICE, use_fused=fused, streaming=streaming,
                                results_parent=WORK / "accuracy" / f"sim_coupled_{streaming}_{fused}")
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        if not sim.run() or sim.iterations != APP_STEPS:
            raise RuntimeError(f"sim_coupled res 2 {streaming} (use_fused={fused}) failed")
        runs[fused] = sim
    k, p = runs[True], runs[False]
    d = (max_diff(k.rho, p.rho), max_diff(k.u, p.u),
         scaled_diff(k.phi, p.phi, local_scale(p.phi)))
    step, launches = k._coupled_step, sum(kernel_launches(k).values())
    log("accuracy", path=f"sim_coupled_res2_{streaming}", steps=APP_STEPS,
        coupled_kernel=k.coupled_kernel, max_drho=d[0], max_du=d[1], max_dphi_scaled=d[2],
        max_abs_phi=float(p.phi.abs().max()), launches=launches, plain_calls=step.plain_calls)
    if not (all(x <= TOL_APP for x in d) and launches == APP_STEPS
            and k.coupled_kernel == f"one-kernel-{streaming}"
            and step.plain_calls == 0 and p.coupled_kernel == "plain"):
        raise RuntimeError(f"sim_coupled res 2 {streaming}: kernel vs plain over {APP_STEPS} "
                           f"steps: {d}")


def app_kernel_vs_plain(name: str, streaming: str) -> None:
    """An app at resolution 2 with ``streaming``, APP_STEPS steps through the
    kernels (A-B: B4; A-A: B2 and B3, pair dispatch off) and through the
    plain step on the card, from the same initial state."""
    import importlib

    import torch

    app = importlib.import_module(f"tnl_lbm_tpu_torch.apps.{name}")
    runs = {}
    # sim_3 is A-B only; the A-A run holds B2/B3 (sim_1's pairs: sim1_aa_dispatch)
    kw = {"streaming": streaming, "pair_dispatch": False} if streaming == "AA" else {}
    for fused in (True, False):
        sim = app.build(2, device=DEVICE, use_fused=fused,
                        results_parent=WORK / "accuracy" / f"{name}_{streaming}_{fused}", **kw)
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        if not sim.run() or sim.iterations != APP_STEPS:
            raise RuntimeError(f"{name} res 2 {streaming} (use_fused={fused}) failed")
        runs[fused] = sim
    k, p = runs[True], runs[False]
    d_rho, d_u = max_diff(k.rho, p.rho), max_diff(k.u, p.u)
    moved = float(k.u.abs().max())
    launches = sum(kernel_launches(k).values())
    log("accuracy", path=f"{name}_res2_{streaming}", steps=APP_STEPS, max_drho=d_rho,
        max_du=d_u, max_abs_u=moved, launches=launches, plain_calls=k._step.plain_calls)
    if not (d_rho <= TOL_APP and d_u <= TOL_APP and torch.isfinite(k.u).all() and moved > 0
            and launches == APP_STEPS and k._step.plain_calls == 0):
        raise RuntimeError(f"{name} res 2 {streaming}: kernel vs plain over {APP_STEPS} "
                           f"steps: drho {d_rho}, du {d_u}")

# ------------------------------------------------------------------ IBM slice

IBM_RES = 4  # sim_ibm at 384x128x128 with 25 098 points
IBM_STEPS = 200
IBM_PINNED = 8  # CG iterations of the pinned kernel-vs-plain checks
IBM_TABLE = ("phi2", 96, 4096, 10)  # dirac, n, points, steps of the table row


def ibm_sim(res: int, label: str, steps: int, use_fused: bool = True, pinned: bool = False,
            steps_per_dispatch: int = 1, timed: bool = False, collision: str | None = None):
    """sim_ibm at ``res`` on the card, ``steps`` steps from the app's start,
    counted from the end of sim_init; ``pinned``: CG at IBM_PINNED
    iterations with a tolerance it never reaches; ``timed``: CUDA events
    around each step and the step's CG iterations and residual kept
    (``sim.step_log``: (start, end, iterations, residual)); ``collision``:
    an id of ``COLLISIONS_D3Q27`` in place of the app's CUM (the app's
    quadratic equilibrium and total DFs kept)."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_ibm
    from tnl_lbm_tpu_torch.ops.collision import COLLISIONS_D3Q27

    t0 = time.perf_counter()
    sim = sim_ibm.build(res, device=DEVICE, use_fused=use_fused,
                        results_parent=WORK / "ibm" / label)
    if collision is not None:
        sim.cfg = dataclasses.replace(sim.cfg, collision=COLLISIONS_D3Q27[collision])
    build_s = time.perf_counter() - t0
    if timed:
        class Timed(type(sim)):
            def _one_step(self, *args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                super()._one_step(*args)
                end.record()
                self.step_log.append((start, end, self.ibm.last_cg_iters,
                                      self.ibm.last_cg_residual))

        sim.__class__ = Timed
        sim.step_log = []
    if pinned:
        sim.ibm.max_iters, sim.ibm.tol = IBM_PINNED, 1e-30
    sim.steps_per_dispatch = steps_per_dispatch
    sim.phys_final_time = steps * sim.domain.units.phys_dt
    sim.sample_phases_at_finish = False
    sim = counting_from_init(sim)
    if not sim.run() or sim.iterations != steps:
        raise RuntimeError(f"sim_ibm res {res} {label} failed ({sim.iterations} steps)")
    torch.cuda.synchronize()
    sim.build_seconds = build_s
    return sim


def ibm_log_lines(sim, kind: str) -> list:
    """The JSON records of one kind in a run's log_ibm."""
    import re

    text = (sim.results_dir / "log_ibm").read_text()
    return [json.loads(x) for x in re.findall(r'(\{"ibm": "%s".*\})' % kind, text)]


def ibm_profile(sim, steps: int = 10) -> dict:
    """torch.profiler over ``steps`` more steps: device ms per step of the
    two B4 instances and of everything else (the hook's kernels), kernel
    events per step, and the profiled host ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sim._advance(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim._advance(steps)
        wall = (time.perf_counter() - t0) * 1e3
    b4 = hook = 0.0
    events = 0
    for e in prof.key_averages():
        # the device's own events only: an aten op's row repeats its kernels' time
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us <= 0:
            continue
        events += e.count
        if e.key.startswith(("ab_macro", "ab_step_force_field")):
            b4 += us / 1e3
        else:
            hook += us / 1e3
    return {"profiled_ms_per_step": wall / steps, "b4_device_ms_per_step": b4 / steps,
            "hook_device_ms_per_step": hook / steps, "device_events_per_step": events / steps,
            "device_busy_share": (b4 + hook) / wall}


def ibm_kernel_vs_plain(sim, f, label: str, state: str) -> tuple:
    """One hooked step from ``f`` through the kernel route and through the
    plain hooked step on the card, CG pinned, at the step bounds; and the
    hook's effect (the plain step with the hook against the plain step
    without it).  From the "flowing" state (the inflow velocity at every
    site, where the cylinder holds the whole flow back) the effect must
    reach HOOK_EFFECT_MIN, so that a wrong force fails the bounds; from a
    run's final state it is logged only."""
    import torch

    from tnl_lbm_tpu_torch.sim.step import make_step

    ibm, step = sim.ibm, sim._step
    ibm.max_iters, ibm.tol = IBM_PINNED, 1e-30
    consts = sim.cfg.forcing_hook.consts
    nu, u_in = sim.domain.units.lbm_viscosity(), sim.update_inflow(sim.phys_time())
    fk, rk, uk = step(f.clone(), nu, u_in=u_in, hook_consts=consts)
    k_iters = ibm.last_cg_iters
    fp, rp, up = step.plain(f, nu, u_in=u_in, hook_consts=consts)
    p_iters = ibm.last_cg_iters
    torch.cuda.synchronize()
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    del fk, rk, uk, rp, up
    newtonian = make_step(dataclasses.replace(sim.cfg, forcing_hook=None), sim.domain)
    effect = max_diff(fp, newtonian(f, nu, u_in=u_in)[0])
    log("ibm", path=label, compare=f"kernel vs plain hooked step, from the {state} state",
        cg_iterations=f"{k_iters}/{p_iters}", max_df=d[0], max_drho=d[1], max_du=d[2],
        hook_effect_max_df=effect)
    check_step(f"{label}: kernel vs plain hooked step from the {state} state", d)
    if not (k_iters == p_iters == IBM_PINNED
            and (state != "flowing" or effect >= HOOK_EFFECT_MIN)):
        raise RuntimeError(f"{label} from the {state} state: CG {k_iters}/{p_iters}, "
                           f"hook effect {effect}")
    return d


def phase_ibm() -> dict:
    """The immersed-boundary slice: sim_ibm at resolution 4 (384x128x128,
    25 098 points, phi2 "modified": the point-space ELLPACK operator)
    through the hooked pipeline, IBM_STEPS steps per step: B4 macro_only,
    the IBM solve as tensor ops, B4 force_field with the inflow vector.
    Its setup, ms/step (the host clock around the loop, and the median of
    per-step CUDA-event times), MLUPS, the sampled phase split, the CG
    iterations and residual over the steps (min / median / max), peak
    memory, the drag line, finite rho and u, the profiler's split of device
    time between B4 and the hook; then one step from its final state and
    one from the flow at the inflow velocity, kernel against plain, CG
    pinned.  Then sim_ibm res 2, APP_STEPS steps
    through the kernels and through the plain hooked step, CG pinned, rho
    and u within TOL_APP; the same kernel run with steps_per_dispatch=10
    (eager chunks: the hook reads the host) against it; and one row of the
    IBM table (IBM_TABLE, both methods).  Returns the res-4 run's launches
    by kernel name."""
    import torch

    from tnl_lbm_tpu_torch import ibm_tables

    sim = ibm_sim(IBM_RES, "res4", IBM_STEPS, timed=True)
    ibm = sim.ibm
    setup = ibm_log_lines(sim, "setup")[-1]
    matrices = ibm_log_lines(sim, "constructMatrices")[-1]
    log("ibm", path="sim_ibm_res4", shape="x".join(map(str, sim.domain.shape)),
        points=setup["points"], min_spacing=setup["min_spacing"],
        max_spacing=setup["max_spacing"], method=ibm.method, space=ibm.space,
        unique_nodes=ibm.u, ell_width=ibm.E_idx.shape[1] if ibm.E_idx is not None else None,
        build_seconds=f"{sim.build_seconds:.3f}", operators_seconds=matrices["wall_s"])
    launches = report_main(sim, "sim_ibm_res4")
    want = {"ab_step_macro_only": IBM_STEPS, "ab_step_force_field": IBM_STEPS}
    if {k: v for k, v in launches.items() if v} != want or sim._step.route != "pipeline":
        raise RuntimeError(f"sim_ibm res 4: route {sim._step.route}, launches {launches}")
    step_ms = [s.elapsed_time(e) for s, e, _, _ in sim.step_log]
    iters = [it for _, _, it, _ in sim.step_log]
    resid = [r for _, _, _, r in sim.step_log]
    drag = ibm_log_lines(sim, "integrateForce")[-1]
    ms, mlups, peak = run_figures(sim)
    log("ibm", path="sim_ibm_res4", steps=sim.iterations, ms_per_step=f"{ms:.4f}",
        mlups=f"{mlups:.1f}", median_step_event_ms=f"{np.median(step_ms):.4f}",
        min_step_event_ms=f"{min(step_ms):.4f}", max_step_event_ms=f"{max(step_ms):.4f}",
        cg_iterations_min_median_max=f"{min(iters)}/{np.median(iters):g}/{max(iters)}",
        cg_residual_min_median_max=f"{min(resid):.3e}/{np.median(resid):.3e}/{max(resid):.3e}",
        max_memory_allocated_gb=f"{peak:.3f}", drag_iteration=drag["iteration"],
        fx=drag["fx"], fy=drag["fy"], fz=drag["fz"])
    if not (np.isfinite([drag["fx"], drag["fy"], drag["fz"]]).all() and max(resid) <= ibm.tol):
        raise RuntimeError(f"sim_ibm res 4: drag {drag}, CG residuals up to {max(resid)}")
    phases = sim.sample_phase_timers()
    log("ibm", path="sim_ibm_res4", **{f"phase_{k}_ms": f"{v:.4f}" for k, v in phases.items()})
    prof = ibm_profile(sim)
    log("ibm", path="sim_ibm_res4", **{k: f"{v:.4f}" for k, v in prof.items()},
        hook_host_ms_per_step=f"{phases['hook'] - prof['hook_device_ms_per_step']:.4f}")
    del sim.step_log
    sim._spare = None
    torch.cuda.empty_cache()
    ibm_kernel_vs_plain(sim, sim.f, "sim_ibm_res4", "final")
    from tnl_lbm_tpu_torch.sim.config import initial_dfs

    flowing = initial_dfs(sim.cfg, sim.domain, DEVICE, u0=(sim.lbm_inflow_vx, 0.0, 0.0))
    ibm_kernel_vs_plain(sim, flowing, "sim_ibm_res4", "flowing")
    del sim, ibm, flowing
    torch.cuda.empty_cache()

    kernel = ibm_sim(2, "res2_kernel", APP_STEPS, pinned=True)
    plain = ibm_sim(2, "res2_plain", APP_STEPS, use_fused=False, pinned=True)
    chunked = ibm_sim(2, "res2_chunked", APP_STEPS, pinned=True, steps_per_dispatch=10)
    d = (max_diff(kernel.rho, plain.rho), max_diff(kernel.u, plain.u))
    dc = (max_diff(chunked.f, kernel.f), max_diff(chunked.rho, kernel.rho),
          max_diff(chunked.u, kernel.u))
    runs = {"kernel": kernel, "chunked": chunked}
    counts = {k: sum(kernel_launches(s).values()) for k, s in runs.items()}
    log("ibm", path="sim_ibm_res2", steps=APP_STEPS, kernel_vs_plain_max_drho=d[0],
        kernel_vs_plain_max_du=d[1], chunked_vs_per_step_max_df=dc[0],
        chunked_vs_per_step_max_drho=dc[1], chunked_vs_per_step_max_du=dc[2],
        chunked_bit_equal=all(x == 0 for x in dc), chunked_graph_replays=chunked.graph_replays,
        launches_per_step_run=counts["kernel"], launches_chunked=counts["chunked"],
        max_abs_u=float(kernel.u.abs().max()))
    if not (all(x <= TOL_APP for x in d + dc) and chunked.graph_replays == 0
            and counts == {"kernel": 2 * APP_STEPS, "chunked": 2 * APP_STEPS}
            and kernel._step.plain_calls == chunked._step.plain_calls == 0
            and bool(torch.isfinite(kernel.u).all())):
        raise RuntimeError(f"sim_ibm res 2: kernel vs plain {d}, chunked vs per step {dc}, "
                           f"launches {counts}, replays {chunked.graph_replays}")
    del kernel, plain, chunked, runs
    torch.cuda.empty_cache()

    dirac, n, points, steps = IBM_TABLE
    for method in ("modified", "original"):
        row = ibm_tables.run_case(dirac, method, n, points, steps, DEVICE)
        log("ibm_table", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                            for k, v in row.items()}, n=n, steps=steps)
    return launches


# ------------------------------------------------------------------ 2D slice

def golden_geometries() -> Path:
    """The golden corpus' 54 geometry files (scripts/make_golden_geometries.py),
    written once per call of the script."""
    out = WORK / "golden_geos"
    if not (out / "54.txt").exists():
        subprocess.run([sys.executable, str(ROOT / "scripts" / "make_golden_geometries.py"),
                        str(out)], check=True, capture_output=True)
    return out


def check_2d(label: str, d) -> None:
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"d2q9_step vs plain on {label} out of tolerance: {d}")


def phase_compare_2d() -> float:
    """B5 against its plain version on the card: each ``case_2d`` geometry at
    37 x 150 (neither a multiple of the block: the channel, the channel with
    a WALL block in a Bouzidi ring of seeded thetas in (0.05, 0.95) and -1
    links, the periodic-x channel, the box of every code with ring sites on
    the y = 0 edge), SRT and CLBM, force absent and present, the inflow as
    a vector and as a [2, 1, Y] profile on the card: one step from a seeded
    state on both sides, then 4 chained steps on each side, compared at the
    end.  Returns max |df|."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
    from torch_cases import (D2_COLLISIONS, D2_KINDS, FORCE_2D, U_IN_2D, case_2d,
                             parabolic_2d, seeded_2d)

    shape = (37, 150)
    prof = torch.tensor(parabolic_2d(shape[1]), dtype=torch.float32, device=DEVICE)
    worst = 0.0
    for kind in D2_KINDS:
        m, periodic, bz = case_2d(kind, shape)
        for collision in D2_COLLISIONS:
            cfg = interop.config_2d_from_spec(collision)
            dom = interop.domain_from_numpy(m, periodic, lat=cfg.lat, bouzidi=bz)
            step = make_fused_step_2d(cfg, dom, DEVICE)
            d1, d4 = [0.0] * 3, [0.0] * 3
            for force in (None, FORCE_2D):
                for u_in in (U_IN_2D, prof):
                    fk = fp = seeded_2d(cfg, shape, DEVICE, seed=11)
                    for it in range(4):
                        fk, rk, uk = step(fk, NU, u_in=u_in, force=force)
                        fp, rp, up = step.plain(fp, NU, u_in=u_in, force=force)
                        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                        check_2d(f"{kind} {collision} step {it}", d)
                        acc = d1 if it == 0 else d4
                        acc[:] = [max(a, b) for a, b in zip(acc, d)]
            torch.cuda.synchronize()
            log("compare_2d", case=kind, collision=collision, shape="x".join(map(str, shape)),
                codes="+".join(sorted(c.name for c in step.codes)),
                ring_links=0 if bz is None else int((bz >= 0).sum()),
                max_df_1=d1[0], max_drho_1=d1[1], max_du_1=d1[2],
                max_df_4=d4[0], max_drho_4=d4[1], max_du_4=d4[2], launches=step.kernel.launches)
            worst = max(worst, d1[0], d4[0])
    return worst


def golden_run(name: str, bouzidi: str, where: Path, resident: bool = False):
    """One counted golden row: sim2d_3 at resolution 1 on geometry ``name``
    to t = 0.4, run; B5 per step, or each chunk through B5's resident chunk
    (``resident``: ``torch_cases.resident_route``)."""
    from tnl_lbm_tpu_torch.apps import sim2d_3
    from torch_cases import resident_route

    sim = sim2d_3.build(1, str(golden_geometries() / name), bouzidi == "on", final_time=0.4,
                        results_parent=where, values_dir=where / "values", use_fused=True,
                        device=DEVICE)
    if resident:
        resident_route(sim)
    if not counting_from_init(sim).run():
        raise RuntimeError(f"sim2d_3 on {name} (Bouzidi {bouzidi}) failed")
    return sim


def phase_golden_2d(variants: dict) -> dict:
    """sim2d_3 at resolution 1 to the final time 0.4 through B5 on all 108
    rows of the TPU-measured golden corpus (tests/golden/): the 12 rows the
    JAX suite samples must lie within 1e-4 relative; the worst deviation
    over the 108 and the count beyond 1e-4 are printed.  Each row runs with
    its counts set to 0 at the end of sim_init: 1440 launches of the step
    kernel, 0 plain calls, its 20-step chunks replayed from a CUDA graph
    after the first (eager) and the second (captured).  Geometry 1 with
    Bouzidi is run again with each chunk one launch of B5's resident chunk
    (72 launches, no step launch, its graphs replayed): the KE value, f, rho
    and u bit for bit the per-step run's.  Then ``golden_launch_ms`` (the
    kernels timed on a finished row's state), ``golden_route_pairs`` (the
    two routes in turns) and ``golden_row_split`` (the host time of a
    row's parts, with the collector as it runs and frozen)."""
    import csv

    with open(ROOT / "tests" / "golden" / "geometry_ke_values_tpu.csv") as fh:
        golden = {(r["geometry"], r["bouzidi"]): float(r["value"]) for r in csv.DictReader(fh)}
    rel, launches, step_kernel, kept, replays = {}, 0, None, None, 0
    t0 = time.perf_counter()
    for (name, bouzidi), want in golden.items():
        sim = golden_run(name, bouzidi, WORK / "golden" / bouzidi)
        per, chunks, plain = b5_routes(sim)
        if (sim.iterations != GOLDEN_STEPS or per != GOLDEN_STEPS or chunks or plain
                or sim.graph_replays < GOLDEN_REPLAYS):
            raise RuntimeError(f"sim2d_3 on {name}: {sim.iterations} steps, {per} launches, "
                               f"{plain} plain calls, {sim.graph_replays} graph replays")
        replays += sim.graph_replays
        value = sim.value_path.read_text()
        rel[(name, bouzidi)] = abs(float(value) - want) / abs(want)
        launches += per
        step_kernel = sim._step.kernel
        if (name, bouzidi) == ("1.txt", "on"):
            kept = (value, *(t.clone() for t in (sim.f, sim.rho, sim.u)))
            finished = sim
        else:
            del sim
    wall = time.perf_counter() - t0
    resident = golden_run("1.txt", "on", WORK / "golden" / "resident", resident=True)
    routes = b5_routes(resident)
    if routes != (0, GOLDEN_STEPS // GOLDEN_CHUNK, 0):
        raise RuntimeError(f"golden row through the resident chunk: (step launches, chunk "
                           f"launches, plain calls) {routes}")
    same = [kept[0] == resident.value_path.read_text()] + [
        torch_equal(a, b) for a, b in zip(kept[1:], (resident.f, resident.rho, resident.u))]
    log("golden_2d", row="1.txt_on", routes="resident chunk vs per step",
        chunk_launches=routes[1], graph_replays=resident.graph_replays,
        bit_equal_value_f_rho_u="/".join(map(str, same)), value=kept[0].strip())
    if not all(same):
        raise RuntimeError(f"golden row 1 (Bouzidi): the resident chunk's run differs from the "
                           f"per-step run: value, f, rho, u equal {same}")
    chunk = resident.resident.kernel
    del resident
    timing = golden_launch_ms(finished, variants)
    del finished
    worst_row = max(rel, key=rel.get)
    sampled = {f"{g}_{'on' if b else 'off'}": rel[(f"{g}.txt", "on" if b else "off")]
               for g, b in GOLDEN_SAMPLED}
    beyond = sorted(k for k, v in rel.items() if v > TOL_GOLDEN)
    log("golden_2d", rows=len(rel), steps_per_row=GOLDEN_STEPS, launches=launches,
        plain_calls=0, graph_replays=replays, wall_s=f"{wall:.1f}",
        worst_rel=rel[worst_row], worst_row="_".join(worst_row),
        rows_beyond_tol=len(beyond), beyond=beyond or "none",
        sampled_worst_rel=max(sampled.values()))
    log("golden_2d", **{f"rel_{k}": f"{v:.3e}" for k, v in sampled.items()})
    if max(sampled.values()) > TOL_GOLDEN:
        raise RuntimeError(f"golden rows beyond 1e-4 relative: {sampled}")
    golden_route_pairs()
    rows = sorted(golden_geometries().glob("*.txt"))[:SPLIT_ROWS]
    golden_row_split([p.name for p in rows], "chip_smoke")
    return {"step": dataclasses.replace(step_kernel, launches=launches),
            "chunk": dataclasses.replace(chunk), **timing}


#: alternating pairs of ``golden_route_pairs``
ROUTE_PAIRS = 10


def golden_route_pairs() -> dict:
    """B5's two routes at the golden sweep's 128 x 32 in ROUTE_PAIRS
    alternating pairs (the first of a pair alternates): ms per step
    through ``_advance`` (``b5_launch_ms``, graphs replayed) and the wall
    of a whole golden row (geometry 1 with Bouzidi, ``sweep_row_seconds``),
    each through per-step launches and through the resident chunk; the
    pairs the resident chunk wins."""
    for resident in (False, True):  # one of each first, untimed
        b5_launch_ms(True, resident=resident)
        sweep_row_seconds(["1.txt"], True, resident=resident)
    pairs = []
    for i in range(ROUTE_PAIRS):
        order = (True, False) if i % 2 == 0 else (False, True)
        adv = {r: b5_launch_ms(True, resident=r) for r in order}
        row = {r: sweep_row_seconds(["1.txt"], True, resident=r)[0] for r in order}
        pairs.append((adv[True], adv[False], row[True], row[False]))
    out = {"pairs": len(pairs),
           "advance_resident_wins": sum(a < b for a, b, _, _ in pairs),
           "row_resident_wins": sum(c < d for _, _, c, d in pairs)}
    for k, col in (("advance_ms_per_step_resident", 0), ("advance_ms_per_step_per_step", 1),
                   ("row_s_resident", 2), ("row_s_per_step", 3)):
        out[k] = "/".join(f"{p[col]:.6f}" for p in pairs)
    log("golden_routes", card=card_state(), **out)
    return out


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


#: golden rows whose parts ``golden_row_split`` times, per setting
SPLIT_ROWS = 12


def timed_parts(sim):
    """The run's class with its sim_init, each ``_advance`` and
    after_sim_finished timed on the host clock into ``sim.row_times`` (a
    subclass, as ``counting_from_init``, so no closure holds the run)."""

    class Timed(type(sim)):
        def sim_init(self):
            t0 = time.perf_counter()
            super().sim_init()
            self.row_times["sim_init"] = time.perf_counter() - t0

        def _build_step(self):
            t0 = time.perf_counter()
            super()._build_step()
            self.row_times["init_step"] = time.perf_counter() - t0

        def estimate_memory_demands(self):
            t0 = time.perf_counter()
            out = super().estimate_memory_demands()
            self.row_times["init_memory"] = time.perf_counter() - t0
            return out

        def _advance(self, n_steps):
            t0 = time.perf_counter()
            super()._advance(n_steps)
            self.row_times["chunks"].append(time.perf_counter() - t0)

        def after_sim_finished(self):
            t0 = time.perf_counter()
            super().after_sim_finished()
            self.row_times["finish"] = time.perf_counter() - t0

    sim.__class__ = Timed
    sim.row_times = {"chunks": []}
    return sim


def golden_row_split(rows, label: str) -> dict:
    """A golden row's host seconds in parts, over ``rows`` (geometry files,
    with Bouzidi): the build (``sim2d_3.build``: the geometry file, the
    domain, the run directory and its logs), sim_init, the first chunk
    (eager), the second (its capture, then its replay), the other 70
    chunks (replays, the KE loop's counter actions between them in "rest")
    and after_sim_finished (the KE and its file); of sim_init, the step's
    build and the memory estimate (``torch.cuda.mem_get_info``).  Beside
    them, the cyclic collector's full (generation 2) collections during the
    rows and their ms, its longest collection of any generation, the objects
    it tracks and the log handlers of the runs' logger.
    Twice: with the collector as it runs, then with the heap so far frozen
    (``gc.freeze``: a full collection then skips it); medians and maxima in
    ms.  The rows' launches are not counted."""
    import collections
    import gc
    import logging

    from tnl_lbm_tpu_torch.apps import sim2d_3

    full, started, longest = [], [0.0], [0.0]

    def on_gc(phase, info):
        now = time.perf_counter()
        if phase == "start":
            started[0] = now
        else:
            longest[0] = max(longest[0], now - started[0])
        if info["generation"] == 2:
            if phase == "start":
                full.append([now, None])
            elif full and full[-1][1] is None:
                full[-1][1] = now

    out = {}
    gc.callbacks.append(on_gc)
    try:
        for frozen in (False, True):
            if frozen:
                gc.freeze()
            parts, n0, w0 = collections.defaultdict(list), len(full), len(full)
            longest[0] = 0.0
            for name in rows:
                where = WORK / "golden_split" / f"{name}_{frozen}_{time.perf_counter_ns()}"
                t0 = time.perf_counter()
                sim = sim2d_3.build(1, str(golden_geometries() / name), True, final_time=0.4,
                                    results_parent=where, values_dir=where / "values",
                                    device=DEVICE)
                t_build = time.perf_counter() - t0
                timed_parts(sim)
                t1 = time.perf_counter()
                if not sim.run():
                    raise RuntimeError(f"golden row {name} failed")
                t_run = time.perf_counter() - t1
                p, c = sim.row_times, sim.row_times["chunks"]
                parts["build"].append(t_build)
                parts["sim_init"].append(p["sim_init"])
                parts["init_step"].append(p["init_step"])
                parts["init_memory"].append(p["init_memory"])
                parts["eager"].append(c[0])
                parts["capture"].append(c[1])
                parts["replays"].append(sum(c[2:]))
                parts["ke"].append(p["finish"])
                parts["rest"].append(t_run - p["sim_init"] - sum(c) - p["finish"])
                parts["row"].append(t_build + t_run)
                parts["gc_full"].append(sum(b - a for a, b in full[n0:] if b is not None))
                n0 = len(full)
                del sim
            handlers = len(logging.getLogger("tnl_lbm_tpu_torch.main").handlers)
            stats = {f"{k}_ms": f"{np.median(v) * 1e3:.3f}/{max(v) * 1e3:.3f}"
                     for k, v in parts.items()}
            log("golden_split", label=label, gc="frozen" if frozen else "running",
                rows=len(rows), **stats, gc_full_collections=len(full) - w0,
                gc_longest_ms=f"{longest[0] * 1e3:.3f}",
                gc_tracked_objects=len(gc.get_objects()), log_handlers=handlers)
            out[frozen] = {k: list(v) for k, v in parts.items()}
    finally:
        gc.callbacks.remove(on_gc)
        gc.unfreeze()
    return out


def b5_step_ops(domain, collision: str, thetas: bool) -> int:
    """FP32 operations of one B5 step over ``domain``'s map: each site's
    class's count (B5_*_OPS), summed over the map's sites."""
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    m = np.asarray(domain.map)
    count = {code: int((m == code).sum()) for code in GEO}
    collided = count[GEO.FLUID] + count[GEO.OUTFLOW_RIGHT] + count[GEO.FLUID_NEAR_WALL]
    return (B5_MOMENT_OPS * (m.size - count[GEO.NOTHING])
            + (B5_RING_OPS * count[GEO.FLUID_NEAR_WALL] if thetas else 0)
            + B5_EQ_OPS * (count[GEO.INFLOW] + count[GEO.OUTFLOW_EQ])
            + B5_COLLISION_OPS[collision] * collided)


def golden_launch_ms(sim, variants: dict) -> dict:
    """B5's two routes at the golden sweep's 128 x 32 on a finished row's
    state (the launches are another step's and chunk's, not the row's).
    Per step: ms per launch from CUDA events over 200 back-to-back
    launches (the host's dispatch included, as a per-step sweep pays it)
    and the device time per kernel event of torch.profiler over 50 more.
    The resident chunk of GOLDEN_CHUNK steps: 20 launches of the step
    kernel and one chunk from the same state must agree bit for bit, and
    the chunk its plain version within TOL_APP; ms per launch and per step
    (CUDA events over 50 launches), its device time per kernel event
    (profiler over 20), and so timed each of B5_VARIANTS built from
    tests/b5_chunk_ablation.py (``variants``: the sync floor, the site
    update taken out, read as device time per step, since its launches
    are shorter than the wrapper's host time; clusters of 8 and 4 blocks);
    the plain version's ms; the bound (85 B/site, the ring's thetas and the
    profile over 3.35 TB/s; or the FP32 operations the map's sites execute
    (``b5_step_ops``) x GOLDEN_CHUNK steps over the card's FP32 issue
    rate, one slot each, whichever is larger)."""
    import b5_chunk_ablation as ablation
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnl_lbm_tpu_torch.kernels.fused_2d import FusedChunk2D, make_fused_step_2d
    from tnl_lbm_tpu_torch.ops import collision_2d as col2
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    def device_ms(fn, prefix, reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.key.startswith(prefix)]
        us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in events)
        count = sum(e.count for e in events)
        return us / 1e3 / max(count, 1), count

    t0 = time.perf_counter()
    n = GOLDEN_CHUNK
    step = make_fused_step_2d(sim.cfg, sim.domain, DEVICE)
    f, nu = sim.f.clone(), sim.domain.units.lbm_viscosity()
    u_in, out = sim.update_inflow(sim.phys_time()), torch.empty_like(f)
    event_ms = time_ms(lambda: step(f, nu, u_in=u_in, out=out), reps=200)
    step_dev, step_events = device_ms(lambda: step(f, nu, u_in=u_in, out=out), "d2q9_", 50)

    chunk = FusedChunk2D(step)
    a, b = f.clone(), torch.empty_like(f)
    for _ in range(n):
        fs, rs, us = step(a, nu, u_in=u_in, out=b)
        a, b = fs, a
    fk, rk, uk = chunk(f, nu, n, u_in=u_in)
    fp, rp, up = chunk.plain(f, nu, n, u_in=u_in)
    torch.cuda.synchronize()
    bit_equal = all(torch_equal(x, y) for x, y in ((fk, fs), (rk, rs), (uk, us)))
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    if not bit_equal or max(d) > TOL_APP:
        raise RuntimeError(f"the resident chunk at 128x32: bit-equal to {n} launches "
                           f"{bit_equal}, against its plain version {d}")
    plain_ms = time_ms(lambda: chunk.plain(f, nu, n, u_in=u_in), reps=3)
    g, spare = f.clone(), torch.empty_like(f)
    per_variant = {}
    for name, lib in (("kernel", None), *((v, variants[v][0]) for v in B5_VARIANTS)):
        with (ablation.using(lib) if lib is not None else contextlib.nullcontext()):
            ms = time_ms(lambda: chunk(g, nu, n, u_in=u_in, out=spare), reps=50)
            dev, events = device_ms(lambda: chunk(g, nu, n, u_in=u_in, out=spare),
                                    "d2q9_chunk", 20)
            geo = chunk.geometry()
        per_variant[name] = {"ms_per_launch": ms, "ms_per_step": ms / n,
                             "device_ms_per_event": dev, "device_ms_per_step": dev / n,
                             "kernel_events": events, **geo,
                             "cluster": ablation.cluster_of(name)}
        log("golden_chunk", shape="128x32", steps=n, variant=name,
            **{k: (f"{v:.6f}" if isinstance(v, float) else v)
               for k, v in per_variant[name].items()})
    mine = per_variant["kernel"]
    chunk_dev, chunk_events = mine["device_ms_per_event"], mine["kernel_events"]
    dom = sim.domain
    X, Y = dom.shape
    sites = X * Y
    near = int((dom.map == GEO.FLUID_NEAR_WALL).sum())
    t_bytes = (B5_BYTES * sites + 32 * near + 8 * Y) / (HBM_PEAK_GBPS * 1e9) * 1e3
    coll = "clbm" if sim.cfg.collision is col2.collide_clbm_2d else "srt"
    step_ops = b5_step_ops(dom, coll, step.thetas is not None)
    t_ops = ops_ms(step_ops * n, 0, RATES)
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    res = {"step_event_ms_per_launch": event_ms, "step_device_ms_per_event": step_dev,
           "step_kernel_events": step_events,
           "step_bound_ms": B5_BYTES * sites / (HBM_PEAK_GBPS * 1e9) * 1e3,
           "chunk_ms_per_launch": mine["ms_per_launch"], "chunk_ms_per_step": mine["ms_per_step"],
           "chunk_device_ms_per_event": chunk_dev, "chunk_kernel_events": chunk_events,
           "sync_floor_ms_per_step": per_variant["sync_floor"]["device_ms_per_step"],
           "chunk_plain_ms": plain_ms,
           "chunk_bound_ms": bound_ms, "chunk_bound_by": bound_by,
           "chunk_bound_bytes_ms": t_bytes, "chunk_bound_ops_ms": t_ops,
           "chunk_fp32_ops_per_step": step_ops,
           "chunk_max_df": d[0], "chunk_max_drho": d[1], "chunk_max_du": d[2],
           "cluster": mine["cluster"], "seconds": time.perf_counter() - t0}
    log("golden_2d", kernel="d2q9_step+d2q9_chunk", shape="128x32", card=card_state(),
        bit_equal_chunk_vs_launches=bit_equal,
        **{k: (f"{v:.6f}" if isinstance(v, float) else v) for k, v in res.items()})
    return {"timing": res, "per_variant": per_variant}


def app_2d_runs(build, label: str, prepare):
    """(kernel run, plain run) of a 2D app's ``build(use_fused, where)``
    on the card from the same start (``prepare`` edits the built run before
    it starts: its geometry, its final time); the kernel run counted from
    sim_init."""
    runs = []
    for fused in (True, False):
        sim = build(fused, WORK / "apps_2d" / f"{label}_{'kernel' if fused else 'plain'}")
        prepare(sim)
        if fused:
            counting_from_init(sim)
        if not sim.run():
            raise RuntimeError(f"{label} (use_fused={fused}) failed")
        runs.append(sim)
    return runs


def b5_routes(sim) -> tuple[int, int, int]:
    """(B5's per-step launches, its resident chunk's launches, the plain
    calls of both) of a counted 2D run (the chunk's where the run goes
    through ``torch_cases.resident_route``)."""
    chunk = getattr(sim, "resident", None)
    return (sim._step.kernel.launches, chunk.kernel.launches if chunk else 0,
            sim._step.plain_calls + (chunk.plain_calls if chunk else 0))


def compare_app_2d(label: str, k, p, **extra) -> float:
    """max |drho| and |du| of the kernel and plain runs within TOL_APP, B5's
    launches one per step, no plain call; returns max |du|."""
    import torch

    d_rho, d_u = max_diff(k.rho, p.rho), max_diff(k.u, p.u)
    launches, plain = k._step.kernel.launches, k._step.plain_calls
    log("apps_2d", path=label, shape="x".join(map(str, k.domain.shape)), steps=k.iterations,
        max_drho=d_rho, max_du=d_u, max_abs_u=float(k.u.abs().max()), launches=launches,
        plain_calls=plain, **extra)
    if not (d_rho <= TOL_APP and d_u <= TOL_APP and bool(torch.isfinite(k.u).all())
            and launches == k.iterations == p.iterations and plain == 0):
        raise RuntimeError(f"{label}: kernel vs plain run: drho {d_rho}, du {d_u}, "
                           f"{launches} launches, {plain} plain calls")
    return d_u


def phase_apps_2d() -> dict:
    """The three 2D apps through B5, each against the plain step's run on
    the card from the same start: sim2d_3 at resolution 2 (256 x 64) with
    geometry 1's disk scaled by 2 in a ring of seeded thetas, 100 steps;
    sim2d_1 at resolution 4 with ``--use-fused``, 100 steps, then one VTK2D
    cycle of its cut at X/2 read back and held against the card's fields;
    sim2d_2 at resolution 1 on geometry 1 with Bouzidi, the statistics state
    machine compressed as tests/test_sim2d_2.py:24-33 compresses it, with
    the window moved to step 150 so that the inflow has reached the ROI:
    the accumulators, the counts and the exported TKE against the plain
    run's (TKE within 1e-5 relative).  Returns B5's launches and max |du|."""
    from tnl_lbm_tpu_torch.apps import sim2d_1, sim2d_2, sim2d_3
    from tnl_lbm_tpu_torch.sim.state import VTK2D
    from torch_cases import compress_statistics, timing_disk_2d

    def app_steps(sim):
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt

    def disk_and_steps(sim):
        timing_disk_2d(sim.domain)
        app_steps(sim)

    k, p = app_2d_runs(lambda fused, where: sim2d_3.build(
        2, None, results_parent=where, values_dir=where / "values", use_fused=fused,
        device=DEVICE), "sim2d_3_res2", disk_and_steps)
    err = compare_app_2d("sim2d_3_res2_disk", k, p, ke_kernel=k.ke_value, ke_plain=p.ke_value,
                         codes="+".join(sorted(c.name for c in k._step.codes)))
    launches = k._step.kernel.launches

    k, p = app_2d_runs(lambda fused, where: sim2d_1.build(
        4, results_parent=where, use_fused=fused, device=DEVICE), "sim2d_1_res4", app_steps)
    k._write_vtk_2d()
    probe = k.probes_2d[0]
    got = read_vti(k.results_dir / "vtk2D" / f"{probe.name}_{probe.cycle - 1:06d}.vti")
    scalars, vectors = k.output_data((slice(probe.position, probe.position + 1), slice(None)))
    same = (np.array_equal(got["lbm_density"][..., 0], scalars["lbm_density"].cpu().numpy())
            and np.array_equal(got["velocity"][:2, ..., 0], vectors["velocity"].cpu().numpy()))
    if not same or k.cnt[VTK2D].count < 1:
        raise RuntimeError("sim2d_1: the VTK2D cut read back differs from the card's fields")
    err = max(err, compare_app_2d("sim2d_1_res4", k, p, vtk2d=probe.name, cycles=probe.cycle,
                                  read_back="equal"))
    launches += k._step.kernel.launches

    geo = str(golden_geometries() / "1.txt")
    k, p = app_2d_runs(lambda fused, where: sim2d_2.build(
        1, geo, results_parent=where, value_path=str(where / "tke"), use_fused=fused,
        device=DEVICE), "sim2d_2_res1", lambda sim: compress_statistics(sim, 150))
    tke = (k.integrate_tke_roi(), p.integrate_tke_roi())
    d_acc = max(max_diff(getattr(k, n), getattr(p, n))
                for n in ("sum_v", "frozen_mean", "sum_up2", "sum_upmag"))
    same = all(getattr(k, n) == getattr(p, n) for n in (
        "iterations", "mean_samples", "fluc_samples", "means_frozen", "flucs_frozen",
        "tke_value_written")) and [r["event"] for r in k.csv_rows] == [r["event"] for r in p.csv_rows]
    err = max(err, compare_app_2d("sim2d_2_res1_geometry1", k, p, tke_kernel=tke[0],
                                  tke_plain=tke[1], max_d_accumulators=d_acc,
                                  mean_samples=k.mean_samples, fluc_samples=k.fluc_samples))
    if not (same and k.tke_value_written and tke[1] > 0
            and abs(tke[0] - tke[1]) <= TOL_APP * tke[1] and d_acc <= TOL_APP):
        raise RuntimeError(f"sim2d_2: the statistics differ from the plain run's: TKE {tke}, "
                           f"accumulators {d_acc}")
    launches += k._step.kernel.launches
    return {"launches": launches, "err": err}


def card_state() -> str:
    """The card's SM and memory clocks, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def time_2d_sim(label: str = "time_2d"):
    """sim2d_3's channel at resolution 64 (8192 x 2048) with geometry 1's
    disk scaled by 64 in a seeded Bouzidi ring, BENCH_STEPS steps through
    ``Simulation`` (B5 per step: the lattice is over the resident chunk's
    size rule), counted from sim_init."""
    from tnl_lbm_tpu_torch.apps import sim2d_3
    from torch_cases import timing_disk_2d

    where = WORK / label
    sim = sim2d_3.build(TIME_2D_RES, None, results_parent=where, values_dir=where / "values",
                        device=DEVICE)
    timing_disk_2d(sim.domain)
    sim.phys_final_time = BENCH_STEPS * sim.domain.units.phys_dt
    counting_from_init(sim)
    if not sim.run():
        raise RuntimeError("sim2d_3 res 64 failed")
    return sim


def phase_time_2d(floor_gbps: float) -> dict:
    """sim2d_3's channel at resolution 64 (8192 x 2048, the site count of
    256^3) with geometry 1's disk scaled by 64 (centre (2048, 1024), radius
    256) in a one-site Bouzidi ring of seeded thetas: 200 steps through
    ``Simulation`` (counted from sim_init: ms/step, MLUPS, peak memory),
    torch.profiler over 10 more (the device's busy share), and on the state
    after the 200 B5 timed in three windows of 20 launches (the first right
    after the loop, before the profiler; ms is their median, the card's
    clocks, power and temperature read before the first and after the
    last), then against its plain version (one step from the same input,
    step bounds; 3 calls timed, peak memory).  GB/s at the bytes this run's
    data needs, against the P1 floor of this call."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    sim = time_2d_sim()
    launches = report_main(sim, f"sim2d_3_res{TIME_2D_RES}")["d2q9"]
    if launches != BENCH_STEPS:
        raise RuntimeError(f"sim2d_3 res 64: {launches} B5 launches for {BENCH_STEPS} steps")
    kernel = dataclasses.replace(sim._step.kernel)
    dom = sim.domain
    X, Y = dom.shape
    near = int((dom.map == GEO.FLUID_NEAR_WALL).sum())
    bytes_site = B5_BYTES + (32 * near + 8 * Y) / (X * Y)  # thetas at the ring, the profile once
    evolved = sim.iterations
    f, nu, u_in = sim.f.clone(), dom.units.lbm_viscosity(), sim.update_inflow(sim.phys_time())
    step = make_fused_step_2d(sim.cfg, dom, DEVICE)
    out = torch.empty_like(f)
    before = card_state()
    windows = [time_ms(lambda: step(f, nu, u_in=u_in, out=out), reps=20)]
    profile_loop(sim, f"sim2d_3_res{TIME_2D_RES}")
    sim._spare = sim.rho = sim.u = sim.f = None
    torch.cuda.empty_cache()
    windows += [time_ms(lambda: step(f, nu, u_in=u_in, out=out), reps=20) for _ in range(2)]
    after = card_state()
    ms = float(np.median(windows))
    fk, rk, uk = step(f, nu, u_in=u_in)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fp, rp, up = step.plain(f, nu, u_in=u_in)
    torch.cuda.synchronize()
    plain_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    check_2d("sim2d_3 res 64", d)
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    plain_ms = time_ms(lambda: step.plain(f, nu, u_in=u_in), reps=3)
    rate = gbps(bytes_site, ms)
    log("time_2d", kernel="d2q9_step", shape=f"{X}x{Y}", evolved_steps=evolved,
        near_wall_sites=near, bytes_per_site=f"{bytes_site:.4f}", max_df=d[0], max_drho=d[1],
        max_du=d[2], ms=f"{ms:.4f}", windows_ms="/".join(f"{w:.4f}" for w in windows),
        card_before=repr(before), card_after=repr(after), plain_ms=f"{plain_ms:.2f}",
        plain_temporaries_gb=f"{plain_gb:.3f}", gbps=f"{rate:.1f}",
        share_of_p1_floor=f"{rate / floor_gbps:.3f}",
        share_of_3350=f"{rate / HBM_PEAK_GBPS:.3f}", mlups_kernel=f"{X * Y / ms / 1e3:.1f}")
    del sim, f, out
    torch.cuda.empty_cache()
    return {"kernel": kernel, "err": d[0], "time": (ms, plain_ms), "bytes": bytes_site}


# ------------------------------------------------------- the forcing-hook slice

#: B9 per site: rho and u read, the map, F written (B/site)
NN_BYTES = 29
#: a force_field step: the step's bytes and the [3] f32 force read
FF_BYTES = AB_BYTES + 12
#: the u* pass (macro_only): 27 f32 read, the map, rho and u written
MACRO_BYTES = 125
#: B5's force_field variant: the [2] f32 force read beside the step's bytes
B5_FF_EXTRA = 8
HOOKED_STEPS = 100
#: the least max |df| by which the hook must move one step from the seeded
#: 256^3 state, 100 times the step bound
HOOK_EFFECT_MIN = 100 * TOL_F
#: the bench duct's rheology (scripts/bench_hooked.py:56-69)
NN_BENCH_MODEL = "cy"
#: the JSON keys of the slice's kernels, with the ptxas/SASS instance each one's
#: figures come from (the CUM_WELL instances; B5's CLBM one, as sim2d_3 runs it)
NN_INSTANCES = {
    "nn_force": "nn_force_kernel",
    "nn_step_ab": "nn_step_ab_cum_well_kernel",
    "nn_step_even": "nn_step_even_cum_well_kernel",
    "nn_step_odd": "nn_step_odd_cum_well_kernel",
    "ab_step_force_field": "ab_step_force_field_cum_well_kernel",
    "ab_step_macro_only": "ab_macro_well_kernel",
    "aa_even_force_field": "aa_even_force_field_cum_well_kernel",
    "aa_even_macro_only": "aa_even_macro_well_kernel",
    "aa_odd_force_field": "aa_odd_force_field_cum_well_kernel",
    "aa_odd_macro_only": "aa_odd_macro_well_kernel",
    "d2q9_step_force_field": "d2q9_clbm_force_field_kernel",
}
NN_KERNEL_NAMES = tuple(NN_INSTANCES.values()) + tuple(
    f"nn_step_{m}_{n}_kernel" for m in ("ab", "even", "odd") for n in ("cum_quad", "cum_invcum")
) + tuple(f"{p}_force_field_{n}_kernel" for p in ("ab_step", "aa_even", "aa_odd")
          for n in ("cum_quad", "cum_invcum")) + (
    "ab_macro_total_kernel", "aa_even_macro_total_kernel", "aa_odd_macro_total_kernel",
    "d2q9_srt_force_field_kernel")


def check_step(label: str, d) -> None:
    """(|df|, |drho|, |du|) within the step bounds, or raise."""
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"{label} out of tolerance: {d}")


def nn_force_diff(fk, fp, label: str) -> tuple:
    """(max |dF|, max |dF| / max |F|, max |F|) of B9 against its plain
    version, or raise beyond TOL_F relative to max |F| (or at F = 0)."""
    scale = float(fp.abs().max())
    d = max_diff(fk, fp)
    if not (scale > 0 and d <= TOL_F * scale):
        raise RuntimeError(f"{label}: |dF| {d}, max |F| {scale}")
    return d, d / scale, scale


def cuda_kernels(wrapper) -> list:
    """The CudaKernel records of a kernel wrapper (``kernel``, or the
    ``ab``/``even``/``odd`` of the per-parity wrappers)."""
    from tnl_lbm_tpu_torch.kernels.fused import CudaKernel

    return [k for k in (getattr(wrapper, a, None) for a in ("kernel", "ab", "even", "odd"))
            if isinstance(k, CudaKernel)]


def hooked_cfg(cfg, model: str, periodic):
    """``cfg`` with the non-Newtonian hook of ``NN_MODELS[model]`` wrapped as
    ``periodic`` (None: edge-replicated on every axis)."""
    from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
    from torch_cases import NN_MODELS

    return dataclasses.replace(cfg, forcing_hook=make_nn_forcing_hook(NN_MODELS[model],
                                                                      periodic=periodic))


def seeded_field(shape, seed: int, scale: float = 1e-5):
    """A seeded per-site force [D, *S] on the card."""
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(DEVICE)


def phase_compare_hooked() -> dict:
    """The slice's kernels against their plain versions on the card, small
    and seeded, on the wall duct (periodic x), the periodic box with a
    ragged Z and the closed box with an obstacle (tests/torch_cases.py
    nn_case), as the JAX suite varies them:

    - B9 with Carreau-Yasuda and with Casson, the hook's periodicity equal
      to the domain's and not: |dF| <= 1e-6 of max |F|;
    - B10, A-B and A-A (even, odd), 4 chained steps on each side, each
      step to the step bounds; on the duct also with the hook wrapping z
      where the domain does not (the DF reads and the stencil keep two
      flags);
    - the force_field and macro_only variants of B4 and B2/B3 (CUM_WELL and
      CUM with eq_inv_cum) on the duct, the periodic box and the box of
      every code (A-B: ``bc_box``; A-A: ``aa_box``), one step from the same
      input, a seeded per-site force plus a homogeneous one;
    - B5's force_field variant (SRT and CLBM) on the 2D channel, the
      channel with a Bouzidi ring and the periodic channel, one step and 4
      chained steps.
    Returns max |df| per JSON key (B9: |dF|; macro_only: the larger of
    |drho| and |du|) under "err", and B9's largest |dF| / max |F| under
    "nn_force_rel"."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
    from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel
    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
    from tnl_lbm_tpu_torch.models import D2Q9
    from torch_cases import (
        NN_KINDS,
        NN_MODELS,
        U_IN,
        aa_box,
        bc_box,
        case_2d,
        nn_case,
        nn_state,
        seeded_2d,
    )

    dev = torch.device(DEVICE)
    err, rel = dict.fromkeys(NN_INSTANCES, 0.0), 0.0
    force = (FORCE_SMALL, 0.0, 0.0)

    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    for kind in NN_KINDS:
        m, periodic, _, _ = nn_case(kind)
        dom = interop.domain_from_numpy(m, periodic)
        rho, u = on_card(nn_state(dom.shape, seed=3))
        other = None if any(periodic) else (True, True, False)
        for model in ("cy", "casson"):
            for per in (periodic, other):
                b9 = make_nn_force_kernel(NN_MODELS[model], dom, dev, periodic=per)
                fk, fp = b9(rho, u, NU), b9.plain(rho, u, NU)
                torch.cuda.synchronize()
                d = nn_force_diff(fk, fp, f"nn_force vs plain on {kind}/{model}/{per}")
                log("compare_hooked", kernel="nn_force", case=kind, model=model,
                    hook_periodic=repr(per), max_dF=d[0], max_dF_relative=d[1], max_F=d[2])
                err["nn_force"] = max(err["nn_force"], d[0])
                rel = max(rel, d[1])

    for kind in NN_KINDS:
        m, periodic, model, hook_per = nn_case(kind)
        dom = interop.domain_from_numpy(m, periodic)
        rho, u = on_card(nn_state(dom.shape, seed=5))
        for streaming in ("AB", "AA"):
            for per in (hook_per,) + (((True, False, True),) if kind == "duct" else ()):
                cfg = hooked_cfg(interop.config_from_spec("CUM_WELL", "EQ_WELL", True,
                                                          streaming), model, per)
                step = make_fused_nn_step(cfg, dom, NN_MODELS[model], per, dev)
                fk = cfg.eq(cfg.lat, rho, u).float().contiguous()
                fp = fk.clone()
                for it in range(4):
                    parity = it % 2 if streaming == "AA" else 0
                    fk, rk, uk = step(fk, NU, force=force, parity=parity)
                    fp, rp, up = step.plain(fp, NU, force=force, parity=parity)
                    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                    key = ("nn_step_ab" if streaming == "AB"
                           else ("nn_step_even", "nn_step_odd")[parity])
                    log("compare_hooked", kernel=key, case=kind, hook_periodic=repr(per), step=it,
                        max_df=d[0], max_drho=d[1], max_du=d[2])
                    check_step(f"{key} vs plain on {kind}/{per} step {it}", d)
                    err[key] = max(err[key], d[0])

    for label, m, periodic in (("duct",) + nn_case("duct")[:2],
                               ("periodic",) + nn_case("periodic")[:2],
                               ("box", bc_box((24, 20, 150)), (False, False, True))):
        for streaming in ("AB", "AA"):
            mm = aa_box((24, 20, 150)) if label == "box" and streaming == "AA" else m
            dom = interop.domain_from_numpy(mm, periodic)
            u_in = U_IN if label == "box" else None
            field = seeded_field((3,) + dom.shape, seed=9)
            for spec in (("CUM_WELL", "EQ_WELL", True), ("CUM", "EQ_INV_CUM", False)):
                cfg = interop.config_from_spec(*spec, streaming)
                f = rand_f(cfg, dom.shape, dev, seed=13)
                build = make_fused_step if streaming == "AB" else make_fused_step_aa
                ff, macro = build(cfg, dom, dev, force_field=True), build(cfg, dom, dev,
                                                                           macro_only=True)
                for parity in ((0,) if streaming == "AB" else (0, 1)):
                    prefix = "ab_step" if streaming == "AB" else ("aa_even", "aa_odd")[parity]
                    fk, rk, uk = ff(f.clone(), NU, u_in=u_in, force=field, force_add=force,
                                    parity=parity)
                    fp, rp, up = ff.plain(f, NU, u_in=u_in, force=field, force_add=force,
                                          parity=parity)
                    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                    log("compare_hooked", kernel=f"{prefix}_force_field", case=label,
                        variant=spec[0] + "/" + spec[1], max_df=d[0], max_drho=d[1], max_du=d[2])
                    check_step(f"{prefix}_force_field vs plain on {label}", d)
                    err[f"{prefix}_force_field"] = max(err[f"{prefix}_force_field"], d[0])
                    rk, uk = macro(f, NU, force=force, parity=parity)
                    rp, up = macro.plain(f, NU, force=force, parity=parity)
                    d = (0.0, max_diff(rk, rp), max_diff(uk, up))
                    log("compare_hooked", kernel=f"{prefix}_macro_only", case=label,
                        variant=spec[0] + "/" + spec[1], max_drho=d[1], max_du=d[2])
                    check_step(f"{prefix}_macro_only vs plain on {label}", d)
                    err[f"{prefix}_macro_only"] = max(err[f"{prefix}_macro_only"], d[1], d[2])

    for kind in ("channel", "bouzidi", "periodic"):
        m, periodic, bz = case_2d(kind, shape=(37, 150))
        dom = interop.domain_from_numpy(m, periodic, lat=D2Q9, bouzidi=bz)
        field = seeded_field((2,) + dom.shape, seed=17)
        for coll in ("SRT", "CLBM"):
            cfg = interop.config_2d_from_spec(coll)
            step = make_fused_step_2d(cfg, dom, dev, force_field=True)
            fk = seeded_2d(cfg, dom.shape, dev, seed=4)
            fp = fk.clone()
            for it in range(4):
                fk, rk, uk = step(fk, NU, u_in=(0.03, 0.0), force=field, force_add=(1e-5, 0.0))
                fp, rp, up = step.plain(fp, NU, u_in=(0.03, 0.0), force=field,
                                        force_add=(1e-5, 0.0))
                d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                check_step(f"d2q9_step_force_field vs plain on {kind}/{coll} step {it}", d)
                err["d2q9_step_force_field"] = max(err["d2q9_step_force_field"], d[0])
            log("compare_hooked", kernel="d2q9_step_force_field", case=kind, collision=coll,
                steps=4, max_df=d[0], max_drho=d[1], max_du=d[2])
    return {"err": err, "nn_force_rel": rel}


def nn_bench_sim(streaming: str, single: bool, start=None, label: str = "", run: bool = True):
    """``Simulation`` on the 256^3 bench duct with the Carreau-Yasuda hook of
    scripts/bench_hooked.py, HOOKED_STEPS steps with ``use_fused``, counted
    from the end of sim_init.  ``single``: the hook wrapped as the domain
    (the one-kernel route, B10); else built without ``periodic``
    (scripts/profile_hooked.py:32), which runs the pipeline.  ``start``: the
    state the run starts from (an evolved one).  ``run=False`` returns the
    run built and not started."""
    import torch

    from tnl_lbm_tpu_torch.sim.state import Simulation

    class HookedDuct(Simulation):
        def body_force(self, phys_time):
            return np.array([FORCE_BENCH, 0.0, 0.0])

        def sim_init(self):
            super().sim_init()
            if start is not None:
                self.f.copy_(start)
                self._initial_macro()

    cfg, dom = flagship(BENCH_SHAPE, streaming=streaming)
    cfg = hooked_cfg(cfg, NN_BENCH_MODEL, dom.periodic if single else None)
    sim = counting_from_init(HookedDuct(
        cfg, dom, device=DEVICE, sim_id=f"hooked_duct_{label or streaming}",
        results_parent=WORK / "main_hooked", phys_final_time=HOOKED_STEPS * dom.units.phys_dt,
        steps_per_dispatch=10, use_fused=True))
    sim.sample_phases_at_finish = False
    if not run:
        return sim
    if not sim.run():
        raise RuntimeError(f"hooked main path {label} failed (NaN or refused)")
    torch.cuda.synchronize()
    return sim


def hooked_vs_plain(step, f, force, parity: int, label: str, state: str) -> tuple:
    """One hooked step from ``f`` against the plain hooked step on the card
    (the step bounds), and the hook's effect on that step: max |df| between
    the plain hooked step and the plain step without the hook.  On the
    seeded state the effect must reach HOOK_EFFECT_MIN, so that a route
    whose NN force were wrong or missing fails the step bounds; on the
    final state of a run it is logged only (the CY force is near 1e-6
    there).  The input is cloned for the in-place A-A even pipeline.
    Returns (|df|, |drho|, |du|)."""
    import torch

    from tnl_lbm_tpu_torch.sim.step import make_step

    fk, rk, uk = step(f.clone(), NU, force=force, parity=parity)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fp, rp, up = step.plain(f, NU, force=force, parity=parity)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    del fk, rk, uk, rp, up
    newtonian = make_step(dataclasses.replace(step.cfg, forcing_hook=None), step.domain)
    effect = max_diff(fp, newtonian(f, NU, force=force, parity=parity)[0])
    log("main_hooked", path=label, compare=f"kernel vs plain hooked step, from the {state} state",
        parity=parity, max_df=d[0], max_drho=d[1], max_du=d[2], hook_effect_max_df=effect,
        plain_temporaries_gb=f"{peak / 1e9:.3f}")
    check_step(f"{label}: kernel vs plain from the {state} state", d)
    if state == "seeded" and not effect >= HOOK_EFFECT_MIN:
        raise RuntimeError(f"{label}: the hook moves the seeded step by {effect} only")
    return d


def pipeline_parts_vs_plain(step, f, force, parity: int, label: str, state: str):
    """The pipeline's u* pass (macro_only) and B9 at 256^3 on the state
    ``f`` against their plain versions, B9 on the plain u*: ({JSON key:
    max |d|}, B9's |dF| / max |F|)."""
    fb = np.array(force, np.float32)
    prefix = "ab_step" if step.cfg.streaming == "AB" else ("aa_even", "aa_odd")[parity]
    rk, uk = step.macro(f, NU, force=fb, parity=parity)
    rp, up = step.macro.plain(f, NU, force=fb, parity=parity)
    d = (0.0, max_diff(rk, rp), max_diff(uk, up))
    check_step(f"{label}: {prefix}_macro_only vs plain from the {state} state", d)
    del rk, uk
    dF = nn_force_diff(step.nn_force(rp, up, NU), step.nn_force.plain(rp, up, NU),
                       f"{label}: nn_force vs plain from the {state} state")
    log("main_hooked", path=label, compare=f"u* pass and B9 vs plain, from the {state} state",
        parity=parity, max_drho=d[1], max_du=d[2], max_dF=dF[0], max_dF_relative=dF[1],
        max_F=dF[2])
    return {f"{prefix}_macro_only": max(d[1], d[2]), "nn_force": dF[0]}, dF[1]


def time_hooked_kernels(step, f, force, parity: int, floor_gbps: float, res: dict) -> dict:
    """Each kernel of a hooked step's route at 256^3 on the state ``f``
    (CUDA events over 20 launches; plain versions over 3 calls), GB/s at
    its bytes against the P1 floor of this call, its registers.  Returns
    {JSON key: (ms, plain ms)}."""
    import torch

    times, fb = {}, np.array(force, np.float32)
    if step.route == "single_kernel":
        k = step.nn_single
        key = ("nn_step_ab" if step.cfg.streaming == "AB"
               else ("nn_step_even", "nn_step_odd")[parity])
        out = torch.empty_like(f)
        times[key] = (time_ms(lambda: k(f, NU, force=force, parity=parity, out=out), reps=20),
                      time_ms(lambda: k.plain(f, NU, force=force, parity=parity), reps=3))
        del out
        bytes_site = {key: AB_BYTES}
    else:
        prefix = "ab_step" if step.cfg.streaming == "AB" else ("aa_even", "aa_odd")[parity]
        rho0, u0 = step.macro(f, NU, force=fb, parity=parity)
        extra = step.nn_force(rho0, u0, NU)
        work = f.clone()
        times[f"{prefix}_macro_only"] = (
            time_ms(lambda: step.macro(f, NU, force=fb, parity=parity), reps=20),
            time_ms(lambda: step.macro.plain(f, NU, force=fb, parity=parity), reps=3))
        times["nn_force"] = (time_ms(lambda: step.nn_force(rho0, u0, NU), reps=20),
                             time_ms(lambda: step.nn_force.plain(rho0, u0, NU), reps=3))
        ff = step.base
        kw = dict(force=extra, force_add=fb, parity=parity)
        times[f"{prefix}_force_field"] = (
            time_ms(lambda: ff(work, NU, **kw), reps=20),
            time_ms(lambda: ff.plain(f, NU, **kw), reps=3))
        # what force_add saves: the body force summed into the hook's field
        # in one PyTorch call, as the pipeline would run it without
        fb_site = torch.as_tensor(fb, device=f.device).view(3, 1, 1, 1)
        summed = torch.empty_like(extra)
        add_ms = time_ms(lambda: torch.add(extra, fb_site, out=summed), reps=20)
        log("time_hooked", op="hook field + body force, one torch.add (force_add's saving)",
            shape="256^3", parity=parity, ms=f"{add_ms:.4f}")
        del work, extra, rho0, u0, summed
        bytes_site = {f"{prefix}_macro_only": MACRO_BYTES, "nn_force": NN_BYTES,
                      f"{prefix}_force_field": FF_BYTES}
    torch.cuda.empty_cache()
    for key, (ms, plain_ms) in times.items():
        rate = gbps(bytes_site[key], ms)
        log("time_hooked", kernel=key, shape="256^3", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
            bytes_per_site=bytes_site[key], gbps=f"{rate:.1f}",
            share_of_p1_floor=f"{rate / floor_gbps:.3f}",
            registers=res.get(NN_INSTANCES[key], {}).get("registers"))
    return times


def phase_main_hooked(floor_gbps: float, res: dict) -> dict:
    """The hooked main path at 256^3 (the bench duct with
    ``CarreauYasuda(0.1, 1.0, 2.0, 0.5)``, scripts/bench_hooked.py): an
    evolved state from HOOKED_STEPS steps of the one-kernel A-B route from
    rest, then from it, HOOKED_STEPS steps each through ``Simulation`` with
    ``use_fused``: (i) A-B, one kernel (B10 ab); (ii) A-A, one kernel (B10
    even/odd); (iii) A-B pipeline (the hook without ``periodic``: B4's u*
    pass, B9, B4's force_field); (iv) A-A pipeline (B2/B3's).  Each: ms/step,
    MLUPS, peak memory, launches (every step through its route's kernels,
    0 plain calls), the sampled phase times, torch.profiler over 10 more
    steps (``profile_loop``); then one step from the final state against
    the plain hooked step, the route's kernels timed, and for
    the one-kernel routes the pipeline (``single_kernel=False``, the same
    hook) held to B10 from the same state.  Each check is made again from a
    seeded 256^3 state (u at 0.02 per site), where the CY force is large
    (HOOK_EFFECT_MIN), so that the 256^3 gates can tell a wrong NN force;
    on the pipelines the u* pass and B9 are also held to their plain
    versions from both states."""
    import torch

    from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step

    warm = nn_bench_sim("AB", True, label="evolve")
    evolved = warm.f.clone()
    log("main_hooked", path="evolve", steps=warm.iterations,
        launches=kernel_launches(warm)["nn_step_ab"])
    del warm
    torch.cuda.empty_cache()
    half = HOOKED_STEPS // 2
    want = {
        "ab_single": {"nn_step_ab": HOOKED_STEPS},
        "aa_single": {"nn_step_even": half, "nn_step_odd": HOOKED_STEPS - half},
        "ab_pipeline": {"ab_step_macro_only": HOOKED_STEPS, "nn_force": HOOKED_STEPS,
                        "ab_step_force_field": HOOKED_STEPS},
        "aa_pipeline": {"aa_even_macro_only": half, "aa_odd_macro_only": HOOKED_STEPS - half,
                        "nn_force": HOOKED_STEPS, "aa_even_force_field": half,
                        "aa_odd_force_field": HOOKED_STEPS - half},
    }
    seeded = rand_f(flagship(BENCH_SHAPE)[0], BENCH_SHAPE, DEVICE, seed=21)
    kernels, err, times, mlups, rel = {}, {}, {}, {}, 0.0
    for label, want_l in want.items():
        streaming, single = label[:2].upper(), label.endswith("single")
        sim = nn_bench_sim(streaming, single, start=evolved, label=label)
        launches = report_main(sim, f"hooked_{label}")
        ran = {k: v for k, v in launches.items() if v}
        if ran != want_l or sim._step.route != ("single_kernel" if single else "pipeline"):
            raise RuntimeError(f"hooked {label}: route {sim._step.route}, launches {launches}")
        mlups[label] = run_figures(sim)[1]
        for w in sim._step.kernels:
            for k in cuda_kernels(w):
                if k.name in want_l:
                    prev = kernels.get(k.name)
                    kernels[k.name] = dataclasses.replace(
                        k, launches=k.launches + (prev.launches if prev else 0))
        phases = sim.sample_phase_timers()
        log("main_hooked", path=label, **{f"phase_{k}_ms": f"{v:.4f}" for k, v in phases.items()})
        profile_loop(sim, f"hooked_{label}")
        force = sim.body_force(0.0)
        f = sim.f
        sim._spare = None
        torch.cuda.empty_cache()
        parities = (0,) if streaming == "AB" else (0, 1)
        for parity in parities:
            other = ("odd", "even")[parity] if streaming == "AA" else None
            # the kernels whose output is f; macro_only and B9 are held apart
            f_keys = [k for k in want_l if "macro_only" not in k and k != "nn_force"
                      and (other is None or other not in k)]
            for state, f0 in (("final", f), ("seeded", seeded)):
                e = hooked_vs_plain(sim._step, f0, force, parity, f"hooked_{label}", state)[0]
                for key in f_keys:
                    err[key] = max(err.get(key, 0.0), e)
                if not single:
                    parts, r = pipeline_parts_vs_plain(sim._step, f0, force, parity,
                                                       f"hooked_{label}", state)
                    for key, v in parts.items():
                        err[key] = max(err.get(key, 0.0), v)
                    rel = max(rel, r)
            times.update(time_hooked_kernels(sim._step, f, force, parity, floor_gbps, res))
        if single:
            pipe = make_hooked_fused_step(sim.cfg, sim.domain, DEVICE, single_kernel=False)
            for parity in parities:
                for state, f0 in (("final", f), ("seeded", seeded)):
                    fk, rk, uk = sim._step(f0.clone(), NU, force=force, parity=parity)
                    fp, rp, up = pipe(f0.clone(), NU, force=force, parity=parity)
                    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                    log("main_hooked", path=label, compare="one kernel vs pipeline, same hook",
                        state=state, parity=parity, max_df=d[0], max_drho=d[1], max_du=d[2])
                    check_step(f"hooked {label}: one kernel vs pipeline from the {state} state",
                               d)
                    del fk, rk, uk, fp, rp, up
            del pipe
        del sim, f
        torch.cuda.empty_cache()
    log("main_hooked", **{f"mlups_{k}": f"{v:.1f}" for k, v in mlups.items()},
        single_over_pipeline_ab=f"{mlups['ab_single'] / mlups['ab_pipeline']:.3f}",
        single_over_pipeline_aa=f"{mlups['aa_single'] / mlups['aa_pipeline']:.3f}")
    return {"kernels": kernels, "err": err, "times": times, "nn_force_rel": rel}


def phase_blunt() -> None:
    """The physics gate: shear thinning blunts the channel profile.  The
    channel of JAX tests/test_non_newtonian.py:42-78 (4 x 4 x 21, walls on
    the z faces, periodic x and y, nu 0.05, force 5e-6), CUM_WELL in
    float32, BLUNT_STEPS steps from rest and one more through
    ``Simulation``: the Newtonian run through B4, the Carreau-Yasuda one
    (nu0 0.5, lambda 500, a 2, n 0.3, the hook wrapped as the domain)
    through B10 - a domain smaller than B10's tile, with a ragged Z.  The
    shape factor of the CY run must lie more than 0.01 below the Newtonian
    one, and each within 1e-3 of the JAX XLA step's value."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
    from tnl_lbm_tpu_torch.sim.state import Simulation
    from torch_cases import (
        BLUNT_FORCE,
        BLUNT_JAX,
        BLUNT_MODEL,
        BLUNT_NU,
        BLUNT_STEPS,
        blunt_channel,
        shape_factor,
    )

    class Channel(Simulation):
        def body_force(self, phys_time):
            return np.array(BLUNT_FORCE)

    m, periodic = blunt_channel()
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=BLUNT_NU)
    if abs(dom.units.lbm_viscosity() - BLUNT_NU) > 1e-12:
        raise RuntimeError(f"the channel's lattice viscosity is {dom.units.lbm_viscosity()}")
    base = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB")
    factors = {}
    for label, hook in (("newtonian", None),
                        ("carreau_yasuda", make_nn_forcing_hook(BLUNT_MODEL, periodic=periodic))):
        sim = counting_from_init(Channel(
            dataclasses.replace(base, forcing_hook=hook), dom, device=DEVICE,
            sim_id=f"blunt_{label}", results_parent=WORK / "blunt",
            phys_final_time=(BLUNT_STEPS + 1) * dom.units.phys_dt, use_fused=True))
        sim.sample_phases_at_finish = False
        if not sim.run():
            raise RuntimeError(f"blunt channel {label} failed")
        launches = report_main(sim, f"blunt_{label}")
        key = "ab" if hook is None else "nn_step_ab"
        if {k: v for k, v in launches.items() if v} != {key: BLUNT_STEPS + 1}:
            raise RuntimeError(f"blunt channel {label}: launches {launches}")
        factors[label] = shape_factor(sim.u[0, 0, 0].cpu().numpy())
        log("blunt", run=label, shape_factor=f"{factors[label]:.6f}",
            jax_xla=f"{BLUNT_JAX[label]:.5f}", kernel="B10" if hook else "B4")
    drop = factors["newtonian"] - factors["carreau_yasuda"]
    log("blunt", drop=f"{drop:.6f}", gate="> 0.01", jax_drop="0.01302")
    if not drop > 0.01 or any(abs(factors[k] - BLUNT_JAX[k]) > 1e-3 for k in factors):
        raise RuntimeError(f"blunted profile: {factors} (JAX {BLUNT_JAX})")


def phase_coupled_hooked() -> dict:
    """sim_coupled at resolution 2 with the Carreau-Yasuda hook (wrapped as
    its domain): ``coupled_kernel`` "two-kernel", APP_STEPS steps through
    the hooked A-B step then B6 and through the plain steps on the card,
    from the same start (rho, u within TOL_APP, phi relative to its local
    magnitude); then one step from the kernel run's final state, the hooked
    step and B6 against the plain hooked step and the plain ADE step (f,
    rho, u to the step bounds, g and phi to the ADE step's relative to the
    local magnitude).  Returns the launches per JSON key."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.sim.step_ade import make_ade_step, transfer_direction_flags
    from torch_cases import local_scale

    runs = {}
    for fused in (True, False):
        sim = sim_coupled.build(2, device=DEVICE, use_fused=fused,
                                results_parent=WORK / "coupled_hooked" / str(fused))
        sim.cfg = hooked_cfg(sim.cfg, NN_BENCH_MODEL, sim.domain.periodic)
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        sim.sample_phases_at_finish = False
        if not counting_from_init(sim).run():
            raise RuntimeError(f"sim_coupled res 2 with a hook (use_fused={fused}) failed")
        runs[fused] = sim
    k, p = runs[True], runs[False]
    launches = kernel_launches(k)
    if (k.coupled_kernel != "two-kernel" or launches.get("ade") != APP_STEPS
            or sum(v for n, v in launches.items() if n != "ade") < APP_STEPS
            or k._step.plain_calls != 0):
        raise RuntimeError(f"sim_coupled with a hook: {k.coupled_kernel}, {launches}")
    scale = local_scale(p.phi)
    d = (max_diff(k.rho, p.rho), max_diff(k.u, p.u), scaled_diff(k.phi, p.phi, scale))
    log("coupled_hooked", path="sim_coupled_res2", route=k._step.route, steps=APP_STEPS,
        max_drho=d[0], max_du=d[1], max_dphi_scaled=d[2],
        **{f"launches_{n}": v for n, v in launches.items()})
    if not (d[0] <= TOL_APP and d[1] <= TOL_APP and d[2] <= TOL_APP):
        raise RuntimeError(f"sim_coupled with a hook: kernel vs plain run {d}")
    t = k.phys_time()
    u_in, force = k.update_inflow(t), k.body_force(t)
    nu = k.domain.units.lbm_viscosity()
    fk, rk, uk = k._step(k.f.clone(), nu, u_in=u_in, force=force)
    gk, phik = k._ade_step(k.g, uk, k._nu_ade, phi_in=float(k.phi_inflow))
    fp, rp, up = k._step.plain(k.f, nu, u_in=u_in, force=force)
    gp, phip = make_ade_step(k.ade_cfg, k.ade_domain)(
        k.g, up, k._nu_ade, phi_in=float(k.phi_inflow),
        transfer_dirs=torch.as_tensor(transfer_direction_flags(k.ade_cfg.lat, k.ade_domain.map),
                                      device=DEVICE),
        transfer_coeff=k.transfer_coeff)
    scale = local_scale(k.g)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up), scaled_diff(gk, gp, scale),
         scaled_diff(phik, phip, scale))
    log("coupled_hooked", compare="hooked A-B step then B6 vs plain, one step", max_df=d[0],
        max_drho=d[1], max_du=d[2], max_dg_scaled=d[3], max_dphi_scaled=d[4])
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U and d[3] <= TOL_G
            and d[4] <= TOL_PHI):
        raise RuntimeError(f"sim_coupled with a hook: one step kernel vs plain {d}")
    return launches


def phase_hooked_2d(floor_gbps: float) -> dict:
    """The 2D hooked path: sim2d_3's res-64 timing channel (as phase
    time_2d) with the Carreau-Yasuda hook wrapped as its domain,
    HOOKED_STEPS steps through ``Simulation``: the plain u* pass and the
    hook as tensor ops (as the JAX package runs them in XLA), then B5's
    force_field variant, every step; one step from the final state against
    the plain hooked step; B5's force_field variant timed there (20
    launches; plain over 3 calls), GB/s at the bytes this data needs."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim2d_3
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from torch_cases import timing_disk_2d

    where = WORK / "hooked_2d"
    sim = sim2d_3.build(TIME_2D_RES, None, results_parent=where, values_dir=where / "values",
                        device=DEVICE)
    timing_disk_2d(sim.domain)
    sim.cfg = hooked_cfg(sim.cfg, NN_BENCH_MODEL, sim.domain.periodic)
    sim.phys_final_time = HOOKED_STEPS * sim.domain.units.phys_dt
    sim.sample_phases_at_finish = False
    if not counting_from_init(sim).run():
        raise RuntimeError("sim2d_3 res 64 with a hook failed")
    launches = report_main(sim, f"hooked_sim2d_3_res{TIME_2D_RES}")
    if launches != {"d2q9_step_force_field": HOOKED_STEPS}:
        raise RuntimeError(f"the 2D hooked path: launches {launches}")
    kernel = dataclasses.replace(sim._step.base.kernel)
    phases = sim.sample_phase_timers()
    log("hooked_2d", **{f"phase_{k}_ms": f"{v:.4f}" for k, v in phases.items()})
    dom, step = sim.domain, sim._step
    t = sim.phys_time()
    f, nu, u_in = sim.f.clone(), dom.units.lbm_viscosity(), sim.update_inflow(t)
    force = sim.body_force(t)
    sim._spare = sim.rho = sim.u = sim.f = None
    torch.cuda.empty_cache()
    fk, rk, uk = step(f, nu, u_in=u_in, force=force)
    fp, rp, up = step.plain(f, nu, u_in=u_in, force=force)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    log("hooked_2d", compare="kernel vs plain hooked step, from the final state", max_df=d[0],
        max_drho=d[1], max_du=d[2])
    check_step("hooked sim2d_3: kernel vs plain", d)
    del fk, rk, uk, fp, rp, up
    rho0, u0, fluid = step._ustar(f, force, 0)
    extra = step._hook(rho0, u0, nu, fluid, None)
    del rho0, u0, fluid
    torch.cuda.empty_cache()
    X, Y = dom.shape
    near = int((dom.map == GEO.FLUID_NEAR_WALL).sum())
    bytes_site = B5_BYTES + B5_FF_EXTRA + (32 * near + 8 * Y) / (X * Y)
    out = torch.empty_like(f)
    kw = dict(u_in=u_in, force=extra, force_add=force)
    ms = time_ms(lambda: step.base(f, nu, out=out, **kw), reps=20)
    plain_ms = time_ms(lambda: step.base.plain(f, nu, **kw), reps=3)
    rate = gbps(bytes_site, ms)
    log("hooked_2d", kernel="d2q9_step_force_field", shape=f"{X}x{Y}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.2f}", bytes_per_site=f"{bytes_site:.4f}", gbps=f"{rate:.1f}",
        share_of_p1_floor=f"{rate / floor_gbps:.3f}")
    del sim, f, out, extra
    torch.cuda.empty_cache()
    return {"kernel": kernel, "err": d[0], "time": (ms, plain_ms), "bytes": bytes_site}


# ------------------------------------------------------------ dispatch

#: chunks per replay-against-eager compare, and golden rows per timing turn
DISPATCH_CHUNKS, SWEEP_ROWS = 3, 6
#: steps of sim_2 res 2 per timed run (as tests/main_paths_ab.py runs it)
SIM2_TIMED_STEPS = 2000
#: chunks each side of a checkpoint round trip
ROUNDTRIP_CHUNKS = 3
STAT_FIELDS = ("vm", "vm2", "vm_b", "vm2_b")


def chunk_fields(sim, extra=()) -> dict:
    """Copies of a run's state, rho, u, statistics windows and ``extra``."""
    names = ("f", "rho", "u") + tuple(extra) + STAT_FIELDS
    return {n: getattr(sim, n).clone() for n in names if getattr(sim, n, None) is not None}


def eager_chunks(sim):
    """The run's admitted chunks without a graph: the same chunk function,
    eager (an instance attribute over ``_graph_chunk``)."""
    sim._graph_chunk = sim._chunk
    return sim


def per_step_only(sim):
    """The run without the chunked dispatch: the gate refuses every chunk,
    as the JAX tests turn the scan off (tests/test_scan_dispatch.py:49-58)."""
    sim._scan_chunk_args = lambda n, uin0=None: None
    return sim


def replay_vs_eager(sim, label: str, chunks: int = DISPATCH_CHUNKS) -> dict:
    """From the run's current state (its chunks warmed and captured),
    ``chunks`` dispatch chunks replayed from CUDA graphs, then from the
    same state and buffers the same chunks run eagerly: every field must be
    equal bit for bit.  The replays must add the launches the eager chunks
    make."""
    from tnl_lbm_tpu_torch.kernels.fused import kernel_counters

    k = sim.steps_per_dispatch
    start, bufs = chunk_fields(sim), (sim.f, sim._spare)
    counts = (sim.iterations, sim.stat_counter, sim.stat2_counter)
    kernels = kernel_counters(sim._step, sim._pair, getattr(sim, "resident", None))
    before, replays = [x.launches for x in kernels], sim.graph_replays
    for _ in range(chunks):
        sim._advance(k)
    graph_launches = [x.launches - b for x, b in zip(kernels, before)]
    replayed = sim.graph_replays - replays
    graph = chunk_fields(sim)
    sim.f, sim._spare = bufs
    for n, t in start.items():
        getattr(sim, n).copy_(t)
    sim.iterations, sim.stat_counter, sim.stat2_counter = counts
    before = [x.launches for x in kernels]
    eager_chunks(sim)
    try:
        for _ in range(chunks):
            sim._advance(k)
    finally:
        del sim._graph_chunk
    eager_launches = [x.launches - b for x, b in zip(kernels, before)]
    diffs = {n: max_diff(graph[n], getattr(sim, n)) for n in graph}
    log("dispatch", route=label, shape="x".join(map(str, sim.domain.shape)), steps=chunks * k,
        replays=replayed, graphs=len(sim._graphs), launches=sum(graph_launches),
        **{f"max_d{n}": d for n, d in diffs.items()},
        bit_equal=all(d == 0 for d in diffs.values()))
    if replayed != chunks or graph_launches != eager_launches or sum(eager_launches) <= 0:
        raise RuntimeError(f"{label}: {replayed} replays of {chunks} chunks, launches "
                           f"{graph_launches} replayed against {eager_launches} eager")
    if any(d != 0 for d in diffs.values()):
        raise RuntimeError(f"{label}: the graph replay differs from the eager chunk: {diffs}")
    return diffs


def warmed(sim, stats: bool = False):
    """sim_init (with both statistics windows when ``stats``), then three
    chunks: the eager warm-up and a capture from each buffer."""
    sim.collect_stats = sim.collect_stats2 = stats
    sim.sample_phases_at_finish = False
    sim.sim_init()
    for _ in range(3):
        sim._advance(sim.steps_per_dispatch)
    return sim


def dispatch_routes():
    """(label, build) of each route whose graph is held to its eager chunk."""
    from tnl_lbm_tpu_torch.apps import sim2d_3, sim_1, sim_2
    from torch_cases import resident_route

    geo = str(golden_geometries() / "1.txt")
    where = WORK / "dispatch"

    def sim2(tag, **kw):
        return lambda: warmed(sim_2.build(2, device=DEVICE, use_fused=True,
                                          results_parent=where / tag, **kw), stats=True)

    def golden(tag, hooked=False, resident=False):
        sim = sim2d_3.build(1, geo, True, final_time=0.4, results_parent=where / tag,
                            values_dir=where / tag / "values", device=DEVICE)
        if resident:
            resident_route(sim)
        if hooked:  # the plain u* pass and hook as tensor ops, then B5's force_field
            sim.cfg = hooked_cfg(sim.cfg, NN_BENCH_MODEL, sim.domain.periodic)
        return warmed(sim)

    return (
        ("golden_b5_sim2d_3_res1", lambda: golden("golden")),
        ("golden_b5_chunk_sim2d_3_res1", lambda: golden("golden_resident", resident=True)),
        ("hooked_b5_sim2d_3_res1", lambda: golden("hooked_2d", hooked=True)),
        ("sim_2_res2_pairs_f32", sim2("pairs_f32", streaming="AA", pair_dispatch=True)),
        ("sim_2_res2_pairs_f16", sim2("pairs_f16", streaming="AA", storage="f16")),
        ("sim_2_res2_per_step", sim2("per_step", streaming="AA", pair_dispatch=False)),
        ("sim_2_res2_ab", sim2("ab", streaming="AB")),
        ("sim_1_res2_aa", lambda: warmed(sim_1.build(2, device=DEVICE, streaming="AA",
                                                     results_parent=where / "sim_1"))),
        *((f"hooked_256_{s.lower()}_{'single' if single else 'pipeline'}",
           lambda s=s, single=single: warmed(nn_bench_sim(
               s, single, label=f"dispatch_{s}_{single}", run=False)))
          for s in ("AB", "AA") for single in (True, False)),
    )


def checkpoint_roundtrip(label: str, build, extra=()) -> None:
    """ROUNDTRIP_CHUNKS chunks, ``save_state(background=True)``, a new run
    of the same build resuming from it and ROUNDTRIP_CHUNKS more chunks,
    against 2 x ROUNDTRIP_CHUNKS uninterrupted chunks: f, rho, u, the
    statistics and ``extra`` bit for bit."""
    from tnl_lbm_tpu_torch.io import native

    def advance(sim, chunks):
        for _ in range(chunks):
            sim._advance(sim.steps_per_dispatch)

    whole = build("whole")
    whole.sim_init()
    advance(whole, 2 * ROUNDTRIP_CHUNKS)
    want = chunk_fields(whole, extra)
    del whole
    cut = build("cut")
    cut.sim_init()
    advance(cut, ROUNDTRIP_CHUNKS)
    t0 = time.perf_counter()
    cut.save_state(background=True)
    t_save = time.perf_counter() - t0
    native.flush()
    resumed = build("cut")
    resumed.sim_init()
    if resumed.start_iterations != cut.iterations or native.errors():
        raise RuntimeError(f"{label}: resumed at {resumed.start_iterations} of {cut.iterations} "
                           f"({native.errors()} background writes failed)")
    advance(resumed, ROUNDTRIP_CHUNKS)
    got = chunk_fields(resumed, extra)
    diffs = {n: max_diff(want[n], got[n]) for n in want}
    log("checkpoint", path=label, iterations=resumed.iterations, saved_at=cut.iterations,
        save_call_ms=f"{t_save * 1e3:.1f}", arrays="+".join(sorted(got)),
        bit_equal=all(d == 0 for d in diffs.values()) and got.keys() == want.keys())
    if got.keys() != want.keys() or any(d != 0 for d in diffs.values()):
        raise RuntimeError(f"{label}: the resumed run differs from the uninterrupted one: {diffs}")


def sweep_row_seconds(rows, chunked: bool, resident: bool = False) -> list:
    """Wall seconds of each golden row (sim2d_3 res 1 to t = 0.4, its
    build and run) with the chunked dispatch (B5 per step, or each chunk
    through B5's resident chunk with ``resident``) or per step from
    Python."""
    from tnl_lbm_tpu_torch.apps import sim2d_3

    geos, out = golden_geometries(), []
    for name in rows:
        where = WORK / "sweep_timing" / f"{name}_{chunked}_{time.perf_counter_ns()}"
        t0 = time.perf_counter()
        sim = sim2d_3.build(1, str(geos / name), True, final_time=0.4, results_parent=where,
                            values_dir=where / "values", device=DEVICE)
        if resident:  # a parent checkout's torch_cases may lack it: imported here
            from torch_cases import resident_route

            resident_route(sim)
        if not chunked:
            per_step_only(sim)
        if not sim.run() or sim.iterations != GOLDEN_STEPS:
            raise RuntimeError(f"golden row {name} failed")
        out.append(time.perf_counter() - t0)
    return out


def b5_launch_ms(chunked: bool, resident: bool = False) -> float:
    """B5 at 128 x 32 in sim2d_3's run: ms per step from CUDA events over
    20 chunks of 20 steps through ``_advance``: B5 per step, or each chunk
    one launch of its resident chunk (``resident``); the chunk replayed
    from its graph or run eagerly (a resident chunk: one direct launch)."""
    from tnl_lbm_tpu_torch.apps import sim2d_3

    where = WORK / "sweep_timing" / f"b5_{chunked}_{time.perf_counter_ns()}"
    sim = sim2d_3.build(1, str(golden_geometries() / "1.txt"), True, final_time=10.0,
                        results_parent=where, values_dir=where / "values", device=DEVICE)
    if resident:
        from torch_cases import resident_route

        resident_route(sim)
    warmed(sim)
    if not chunked:
        eager_chunks(sim)
    return time_ms(lambda: sim._advance(20), reps=20) / 20


def sim2_mlups(pair_dispatch, chunked: bool) -> float:
    """sim_2 res 2 A-A through ``run``, SIM2_TIMED_STEPS steps: MLUPS."""
    from tnl_lbm_tpu_torch.apps import sim_2

    tag = f"{'pairs' if pair_dispatch else 'per_step'}_{'graph' if chunked else 'eager'}"
    sim = sim_2.build(2, device=DEVICE, streaming="AA", use_fused=True,
                      pair_dispatch=pair_dispatch,
                      results_parent=WORK / "sim2_timing" / f"{tag}_{time.perf_counter_ns()}")
    sim.phys_final_time = SIM2_TIMED_STEPS * sim.domain.units.phys_dt
    if not chunked:
        per_step_only(sim)
    if not counting_from_init(sim).run():
        raise RuntimeError(f"sim_2 res 2 ({tag}) failed")
    return run_figures(sim)[1]


def phase_dispatch_and_checkpoint() -> dict:
    """The chunked dispatch as CUDA graphs and the checkpoints, on the card.

    Replay against eager: each route of ``dispatch_routes`` warmed (one
    eager chunk, a capture from each buffer), then DISPATCH_CHUNKS chunks
    from its graphs held to the same chunks run eagerly from the same
    state, bit for bit, with the same launches.  Round trips: sim_2 res 2
    in pairs and A-B (both statistics windows on), sim_coupled res 2 (g
    too) and sim2d_2 res 1 (its accumulators, the statistics from step 2)
    through a background checkpoint, bit for bit.  Timings, in turns: the
    golden sweep's wall per row through the resident chunk, B5 per step
    from its graph and per step from Python, and B5's ms per step through
    ``_advance`` on four routes: the resident chunk replayed from its graph
    or launched directly, B5 per step from its graph or eager; sim_2 res
    2's MLUPS in pairs and per step, graph and per step from Python."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim2d_2, sim_2, sim_coupled
    from torch_cases import compress_statistics

    t0 = time.perf_counter()
    for label, build in dispatch_routes():
        sim = build()
        replay_vs_eager(sim, label)
        del sim
        torch.cuda.empty_cache()

    def sim2(streaming, **kw):
        def build(tag):
            sim = sim_2.build(2, device=DEVICE, use_fused=True, streaming=streaming,
                              results_parent=WORK / "roundtrip" / f"sim_2_{streaming}" / tag,
                              **kw)
            sim.collect_stats = sim.collect_stats2 = True
            return sim
        return build

    def coupled(tag):
        return sim_coupled.build(2, use_fused=True, device=DEVICE,
                                 results_parent=WORK / "roundtrip" / "coupled" / tag)

    def stats_2d(tag):
        sim = sim2d_2.build(1, str(golden_geometries() / "1.txt"), device=DEVICE,
                            results_parent=WORK / "roundtrip" / "sim2d_2" / tag)
        compress_statistics(sim)
        return sim

    checkpoint_roundtrip("sim_2_res2_pairs", sim2("AA", pair_dispatch=True))
    checkpoint_roundtrip("sim_2_res2_ab", sim2("AB"))
    checkpoint_roundtrip("sim_coupled_res2", coupled, extra=("g", "phi"))
    checkpoint_roundtrip("sim2d_2_res1", stats_2d, extra=("sum_v",))
    t_checks = time.perf_counter() - t0

    csv_rows = sorted(p.name for p in golden_geometries().glob("*.txt"))[:SWEEP_ROWS]
    walls = {}
    sweeps = {"resident": (True, True), "per_step_graph": (True, False),
              "per_step_python": (False, False)}
    for route in (*sweeps, *reversed(sweeps)):
        walls.setdefault(route, []).extend(sweep_row_seconds(csv_rows[:SWEEP_ROWS // 2],
                                                             *sweeps[route]))
    routes = {"resident_graph": (True, True), "resident_direct": (False, True),
              "per_step_graph": (True, False), "per_step_eager": (False, False)}
    launch = {r: [] for r in routes}
    for route in (*routes, *reversed(routes)):
        launch[route].append(b5_launch_ms(*routes[route]))
    mlups = {}
    for pair in (True, False):
        for chunked in (True, False, False, True):
            mlups.setdefault((pair, chunked), []).append(sim2_mlups(pair, chunked))
    log("dispatch_timing", card=card_state(),
        **{f"sweep_row_s_{r}": f"{np.median(v):.4f}" for r, v in walls.items()},
        sweep_rows=len(walls["resident"]),
        **{f"b5_ms_per_step_{r}": "/".join(f"{m:.5f}" for m in v) for r, v in launch.items()},
        **{f"sim_2_res2_{'pairs' if p else 'per_step'}_{'graph' if c else 'python'}_mlups":
           "/".join(f"{m:.1f}" for m in v) for (p, c), v in mlups.items()},
        checks_seconds=f"{t_checks:.1f}", seconds=f"{time.perf_counter() - t0:.1f}")
    return {"walls": walls, "launch": launch, "mlups": mlups}


#: float64 bounds of the kernel-vs-plain compares, and of the velocity duct's
#: 100 steps against the plain run on the card (float32's: TOL_APP)
F64_TOL = {"f": 1e-12, "rho": 2e-12, "u": 1e-12}
F64_APP_TOL = 1e-10
#: B/site of a float64 step or pair: 27 f64 in and out, the map, rho and u
F64_BYTES = 465
#: an inflow velocity and a force that float32 cannot hold
U_IN64 = (0.0312345678901234, 0.0051234567890123, -0.0041234567890123)
FORCE64 = (1.2345678901234e-5, 2.345678901234e-7, -3.45678901234e-7)
#: the record's keys of this slice's instances -> their kernels (SASS names)
F64_KERNELS = {"ab_step_f64": ("ab_step_f64_cum_well_kernel",),
               "ab_step_profile": ("ab_step_profile_cum_well_kernel",),
               "ab_step_f64_profile": ("ab_step_f64_profile_cum_well_kernel",),
               "aa_even_f64": ("aa_even_f64_cum_well_kernel",),
               "aa_odd_f64": ("aa_odd_f64_lean_kernel", "aa_odd_f64_cum_well_kernel"),
               "aa_pair_f64": ("aa_pair_f64_kernel",)}
#: sim_2 res 2's float64 runs end here (f32's at 200 s): their L1 is held to the
#: start-up solution and beside the f32 runs' at the same iteration
SIM2_F64_FINAL_TIME = 50.0
VELOCITY_CHECK_RES, VELOCITY_CHECK_STEPS = 4, 100
VELOCITY_RES, VELOCITY_STEPS = 8, 200


def seeded_state64(shape, dtype, seed=7):
    """CUM_WELL's equilibrium of a seeded developed state (rho 1 +- 0.01,
    |u| ~ 0.02) computed in float64 on the card, in ``dtype``."""
    import torch

    from tnl_lbm_tpu_torch import interop

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rho = 1 + 0.01 * torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float64)
    u = 0.02 * torch.randn((3,) + tuple(shape), generator=gen, device=DEVICE, dtype=torch.float64)
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB", dtype="float64")
    return cfg.eq(cfg.lat, rho, u).to(dtype).contiguous()


def agree(out, plain, tol: dict, label: str) -> tuple:
    """max |df|, |drho|, |du| of a launch against its plain version, held
    to ``tol``."""
    import torch

    torch.cuda.synchronize()
    d = tuple(max_diff(a, b) for a, b in zip(out, plain))
    if not (d[0] <= tol["f"] and d[1] <= tol["rho"] and d[2] <= tol["u"]):
        raise RuntimeError(f"{label}: kernel vs plain out of tolerance {tol}: {d}")
    return d


def f64_compares() -> dict:
    """Each new instance against its plain version: B4 float64 and B4's
    profile instance (float32, float64; [3, 1, Y, Z] and [3, X, Y, Z]) on
    the box of every code, and B4 float64 on sim_2's res-2 A-B duct, two
    steps; B2/B3 float64 on sim_2's res-2 duct
    (the lean odd instance) and on the box of every A-A code, four steps;
    B1 float64 on sim_2's res-2 duct and on a 20x36x40 box over x segments
    of 7, per closed/periodic combination, two pairs.  Returns the record's
    max |df| per key."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa, make_fused_step_aa
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from torch_cases import aa_box, bc_box

    err = dict.fromkeys(F64_KERNELS, 0.0)
    tol32 = {"f": TOL_F, "rho": TOL_RHO, "u": TOL_U}
    shape = (24, 20, 150)
    box = interop.domain_from_numpy(bc_box(shape), (False, False, True))
    rng = np.random.default_rng(3)
    profiles = {p: 0.03 * rng.standard_normal((3, X) + shape[1:])
                for p, X in (("1yz", 1), ("xyz", shape[0]))}
    # sim_2 res 2's A-B duct, the map of its --precision double A-B run
    res2_ab = sim_2.build(2, device="cpu", streaming="AB", precision="double",
                          results_parent=WORK / "double_compare_ab").domain
    for dtype, tag in (("float64", "_f64"), ("float32", "")):
        cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB", dtype=dtype)
        tol = F64_TOL if dtype == "float64" else tol32
        cases = [("24x20x150", box, (("vector",) if dtype == "float64" else ()) + tuple(profiles))]
        if dtype == "float64":
            cases.append(("sim_2_res2", res2_ab, ("vector",)))
        for label, dom, inflows in cases:
            step = make_fused_step(cfg, dom, DEVICE)
            for inflow in inflows:
                u_in = np.asarray(U_IN64) if inflow == "vector" else profiles[inflow]
                f = seeded_state64(dom.shape, cfg.compute_dtype)
                for it in range(2):
                    out = step(f, NU, u_in=u_in, force=FORCE64)
                    d = agree(out, step.plain(f, NU, u_in=u_in, force=FORCE64), tol,
                              f"ab_step{tag} {label} {inflow} step {it}")
                    f = out[0]
                key = f"ab_step{tag}" + ("" if inflow == "vector" else "_profile")
                err[key] = max(err[key], d[0])
                log("double_and_profile", compare=key, inflow=inflow, case=label,
                    max_df=d[0], max_drho=d[1], max_du=d[2])
    res2 = sim_2.build(2, device=DEVICE, streaming="AA", precision="double",
                       results_parent=WORK / "double_compare")
    aa_cases = (("sim_2_res2", res2.domain),
                ("aa_box", interop.domain_from_numpy(aa_box(shape), (False, False, True))))
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA", dtype="float64")
    for label, dom in aa_cases:
        step = make_fused_step_aa(cfg, dom, DEVICE)
        f = seeded_state64(dom.shape, torch.float64)
        for it in range(4):
            plain = step.plain(f, NU, u_in=U_IN64, force=FORCE64, parity=it % 2)
            out = step(f, NU, u_in=U_IN64, force=FORCE64, parity=it % 2)
            d = agree(out, plain, F64_TOL, f"aa f64 {label} step {it}")
            key = "aa_even_f64" if it % 2 == 0 else "aa_odd_f64"
            err[key] = max(err[key], d[0])
            f = out[0]
        log("double_and_profile", compare="aa_f64", case=label, odd_instance=step.variant,
            max_df=max(err["aa_even_f64"], err["aa_odd_f64"]))
    pair_cases = [("sim_2_res2", res2.domain, None)]
    m = np.zeros((20, 36, 40), np.uint8)  # sim_2's duct on a box no column tile divides
    m[:, 1] = m[:, -2] = m[:, :, 1] = m[:, :, -2] = GEO.WALL
    m[:, 0] = m[:, -1] = m[:, :, 0] = m[:, :, -1] = GEO.NOTHING
    m[7, 9, 11] = GEO.NOTHING
    for periodic in ((False, False, False), (True, False, True), (True, True, True)):
        mm = m.copy()
        if periodic == (True, True, True):
            mm[:] = GEO.FLUID
            mm[3, 4, 5] = GEO.NOTHING
        pair_cases.append((f"box_{''.join('p' if p else 'c' for p in periodic)}",
                           interop.domain_from_numpy(mm, periodic), 7))
    for label, dom, seg_len in pair_cases:
        pair = make_fused_pair2_aa(cfg, dom, DEVICE, seg_len=seg_len)
        f = seeded_state64(dom.shape, torch.float64)
        for it in range(2):
            out = pair(f, NU, force=FORCE64)
            d = agree(out, pair.plain(f, NU, force=FORCE64), F64_TOL, f"aa_pair_f64 {label}")
            err["aa_pair_f64"] = max(err["aa_pair_f64"], d[0])
            f = out[0]
        log("double_and_profile", compare="aa_pair_f64", case=label, seg_len=seg_len or "auto",
            geometry=json.dumps(pair.geometry()), max_df=d[0], max_drho=d[1], max_du=d[2])
    del res2
    torch.cuda.empty_cache()
    return err


def velocity_domain(res: int, precision: str):
    """(cfg, domain, profile) of sim_2 --velocity at ``res`` without a run."""
    from tnl_lbm_tpu_torch.apps import sim_2

    sim = sim_2.build(res, device="cpu", use_forcing=False, precision=precision,
                      results_parent=WORK / "velocity_domains")
    return sim.cfg, sim.domain, sim.u_profile


def f64_timings(floor_gbps: float, f64_ops: dict) -> dict:
    """Each new instance at 256^3, timed on CUDA events (20 launches;
    plain: one call), then one launch held to its plain version on the same
    input (``agree``, the float64 bounds; the float32 profile instance at
    the step bounds): B4 float64 on the bench duct A-B; B2, B3 (lean) and B1
    float64 on the bench duct A-A; B4's profile instances (float32, float64)
    on sim_2 --velocity res 8, in turns with the vector instance on the same
    map and state.  The check comes after the timing: timed after the plain
    call's whole-array temporaries, B4 and B2 float64 read up to 5% slower
    (``tests/f64_timing_order.py``).  Returns key -> (ms, plain ms), key ->
    (bytes per site, ops per site) and key -> max |df| at 256^3."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa, make_fused_step_aa
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    times, footprint, err = {}, {}, {}
    sites = float(np.prod(BENCH_SHAPE))
    force = (FORCE_BENCH, 0.0, 0.0)
    tol32 = {"f": TOL_F, "rho": TOL_RHO, "u": TOL_U}

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def check(key, launch, plain, tol=F64_TOL):
        """The plain call first, alone beside the input (its whole-array
        temporaries peak there), then one launch on the same input."""
        want = plain()
        free()
        d = agree(launch(), want, tol, f"{key} at 256^3")
        err[key] = d[0]
        log("double_and_profile", compare=key, shape="256^3", max_df=d[0], max_drho=d[1],
            max_du=d[2])
        del want
        free()

    def record(key, ms, plain_ms, bytes_per_site, ops):
        times[key] = (ms, plain_ms)
        footprint[key] = (bytes_per_site, ops)
        b, by = bound(bytes_per_site, ops)
        log("double_and_profile", kernel=key, shape="256^3", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", gbps=f"{bytes_per_site * sites / ms / 1e6:.1f}",
            share_of_p1=f"{bytes_per_site * sites / ms / 1e6 / floor_gbps:.3f}",
            bound_ms=f"{b:.4f}", bound_by=by,
            bytes_bound_ms=f"{bytes_per_site * sites / (HBM_PEAK_GBPS * 1e9) * 1e3:.4f}",
            p1_bound_ms=f"{bytes_per_site * sites / (floor_gbps * 1e9) * 1e3:.4f}",
            fp64_slots_per_site=ops[2], fp64_bound_ms=f"{ops_ms(0, 0, RATES, ops[2] * sites):.4f}",
            fp32_slots_per_site=ops[0])

    cfg, dom = flagship(BENCH_SHAPE, streaming="AB")
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float64)
    step = make_fused_step(cfg, dom, DEVICE)
    f = seeded_state64(BENCH_SHAPE, torch.float64)
    out = torch.empty_like(f)
    ms = time_ms(lambda: step(f, NU, force=force, out=out), reps=20)
    del out
    free()
    plain_ms = time_ms(lambda: step.plain(f, NU, force=force), reps=1)
    record("ab_step_f64", ms, plain_ms, F64_BYTES, f64_ops["ab_step_f64_cum_well_kernel"])
    check("ab_step_f64", lambda: step(f, NU, force=force), lambda: step.plain(f, NU, force=force))
    del step, f
    free()

    cfg, dom = flagship(BENCH_SHAPE, streaming="AA")
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float64)
    step = make_fused_step_aa(cfg, dom, DEVICE)
    pair = make_fused_pair2_aa(cfg, dom, DEVICE)
    f = seeded_state64(BENCH_SHAPE, torch.float64)
    out = torch.empty_like(f)
    even_ms = time_ms(lambda: step(f, NU, force=force, parity=0), reps=20)
    odd_ms = time_ms(lambda: step(f, NU, force=force, parity=1, out=out), reps=20)
    pair_ms = time_ms(lambda: pair(f, NU, force=force, out=out), reps=20)
    del out
    free()
    plain = {parity: time_ms(lambda: step.plain(f, NU, force=force, parity=parity), reps=1)
             for parity in (0, 1)}
    free()
    pair_plain = time_ms(lambda: pair.plain(f, NU, force=force), reps=1)
    lean = f64_ops["aa_odd_f64_lean_kernel"]
    record("aa_even_f64", even_ms, plain[0], F64_BYTES, f64_ops["aa_even_f64_cum_well_kernel"])
    record("aa_odd_f64", odd_ms, plain[1], F64_BYTES, lean)
    record("aa_pair_f64", pair_ms, pair_plain, F64_BYTES, tuple(2 * v for v in lean))
    log("double_and_profile", pair_f64_geometry=json.dumps(pair.geometry()),
        b2_plus_b3_ms=f"{even_ms + odd_ms:.4f}", pair_over_b2_b3=f"{pair_ms / (even_ms + odd_ms):.3f}")
    free()
    # the even step runs in place: after its check f holds its output
    for key, parity in (("aa_even_f64", 0), ("aa_odd_f64", 1)):
        check(key, lambda: step(f, NU, force=force, parity=parity),
              lambda: step.plain(f, NU, force=force, parity=parity))
    check("aa_pair_f64", lambda: pair(f, NU, force=force), lambda: pair.plain(f, NU, force=force))
    del step, pair, f
    free()

    for precision, key in (("single", "ab_step_profile"), ("double", "ab_step_f64_profile")):
        cfg, dom, prof = velocity_domain(VELOCITY_RES, precision)
        step = make_fused_step(cfg, dom, DEVICE)
        prof = torch.as_tensor(prof, dtype=cfg.compute_dtype, device=DEVICE)
        f = seeded_state64(dom.shape, cfg.compute_dtype)
        out = torch.empty_like(f)
        turns = in_turns({"vector": lambda: step(f, NU, u_in=U_IN64, out=out),
                          "profile": lambda: step(f, NU, u_in=prof, out=out)}, rounds=3, reps=20)
        del out
        free()
        plain_ms = time_ms(lambda: step.plain(f, NU, u_in=prof), reps=1)
        n_in = int(np.isin(dom.map, (GEO.INFLOW_LEFT, GEO.INFLOW)).sum())
        item = 4 if precision == "single" else 8
        per_site = (AB_BYTES if precision == "single" else F64_BYTES) + 3 * item * n_in / sites
        record(key, float(np.median(turns["profile"])), plain_ms, per_site,
               f64_ops[F64_KERNELS[key][0]])
        log("double_and_profile", in_turns=key, shape="256^3 (sim_2 --velocity res 8)",
            profile_ms=" ".join(f"{t:.4f}" for t in turns["profile"]),
            vector_ms=" ".join(f"{t:.4f}" for t in turns["vector"]),
            profile_over_vector=f"{np.median(turns['profile']) / np.median(turns['vector']):.4f}",
            inflow_sites=n_in)
        free()
        check(key, lambda: step(f, NU, u_in=prof), lambda: step.plain(f, NU, u_in=prof),
              F64_TOL if precision == "double" else tol32)
        del step, f, prof
        free()
    return {"times": times, "footprint": footprint, "err": err}


def sim2_counted(label: str, res: int, final_time: float | None = None,
                 steps: int | None = None, **kw):
    """sim_2 at ``res`` on the card through ``Simulation.run`` to
    ``final_time`` or for ``steps`` steps, counted from the end of sim_init;
    returns the run."""
    from tnl_lbm_tpu_torch.apps import sim_2

    sim = sim_2.build(res, device=DEVICE, use_fused=True, results_parent=WORK / label, **kw)
    if final_time is not None:
        sim.phys_final_time = final_time
    if steps is not None:
        sim.phys_final_time = steps * sim.domain.units.phys_dt
    sim = counting_from_init(sim)
    t0 = time.perf_counter()
    if not sim.run():
        raise RuntimeError(f"sim_2 {label} failed (NaN or refused)")
    sim.wall_s = time.perf_counter() - t0
    return sim


def f64_launches(sim) -> dict:
    """The record's keys of this slice -> a run's launches of them."""
    from tnl_lbm_tpu_torch.kernels.fused import kernel_counters

    got = {k.name: k.launches for k in kernel_counters(sim._step, sim._pair)}
    return {key: got.get(key, 0) for key in F64_KERNELS}


def sim2_double_runs(f32_l1: dict) -> dict:
    """sim_2 res 2 --precision double per step, in pairs, under "auto" and
    A-B, to SIM2_F64_FINAL_TIME: each run's last L1 within 5% of the analytic
    start-up solution's at that iteration, beside the float32 run's L1 at
    the same iteration (the reference's precision test); "auto"'s pick
    logged.  Returns the runs' launches per key."""
    launches = dict.fromkeys(F64_KERNELS, 0)
    for label, kw in (("per_step", dict(streaming="AA", pair_dispatch=False)),
                      ("pairs", dict(streaming="AA", pair_dispatch=True)),
                      ("auto", dict(streaming="AA", pair_dispatch="auto")),
                      ("ab_step", dict(streaming="AB"))):
        sim = sim2_counted(f"sim2_f64_{label}", 2, SIM2_F64_FINAL_TIME, precision="double", **kw)
        it, l1, l2 = sim.error_history[-1]
        l1_ref = startup_l1(sim, it)
        rel = abs(l1 / l1_ref - 1)
        ref32 = f32_l1["ab_step" if label == "ab_step" else "per_step"]
        run = f64_launches(sim)
        plain = sim._step.plain_calls + (sim._pair.plain_calls if sim._pair else 0)
        extra = {}
        if label == "auto" and sim.pair_probe_ms is not None:  # None: no probe (a CPU rehearsal)
            t_pair, t_steps = sim.pair_probe_ms
            extra = dict(chose="pair" if sim.pair_dispatch else "per_step",
                         probe_pair_ms=f"{t_pair:.4f}", probe_per_step_ms=f"{t_steps:.4f}")
        log("double_and_profile", sim_2_res2_double=label, l1=f"{l1:.6e}", l2=f"{l2:.6e}",
            iterations=it, wall_s=f"{sim.wall_s:.1f}", l1_startup_solution=f"{l1_ref:.6e}",
            rel_to_startup=f"{rel:.2e}",
            l1_f32_same_iteration=f"{ref32[it]:.6e}" if it in ref32 else "not probed",
            l1_f64_over_f32=f"{l1 / ref32[it]:.6f}" if it in ref32 else "n/a",
            plain_calls=plain, graph_replays=sim.graph_replays,
            **{f"launches_{k}": v for k, v in run.items() if v}, **extra)
        if sim.nan_detected or not rel <= 0.05 or plain or not any(run.values()):
            raise RuntimeError(f"sim_2 res 2 double ({label}): L1 {l1:e} not within 5% of the "
                               f"start-up solution's {l1_ref:e}, or no kernel launch")
        for k, v in run.items():
            launches[k] += v
        del sim
    return launches


def velocity_runs() -> dict:
    """sim_2 --velocity through B4's profile instance: at res 4 (128^3)
    VELOCITY_CHECK_STEPS steps through ``Simulation._advance`` held to the
    same steps of the plain step on the card (f, rho, u within 1e-5 in
    float32, 1e-10 in float64); at res 8 (256^3, the full width)
    VELOCITY_STEPS steps in float32 and float64, with MLUPS.  Returns the
    runs' launches per key."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_2

    launches = dict.fromkeys(F64_KERNELS, 0)
    for precision in ("single", "double"):
        runs = {}
        for fused in (True, False):
            sim = sim_2.build(VELOCITY_CHECK_RES, device=DEVICE, use_forcing=False,
                              precision=precision, use_fused=fused,
                              results_parent=WORK / f"velocity_check_{precision}_{fused}")
            sim.sim_init()
            if fused:
                sim._step.reset_counts()
            sim._advance(VELOCITY_CHECK_STEPS)
            runs[fused] = sim
        kernel, plain = runs[True], runs[False]
        tol = F64_APP_TOL if precision == "double" else TOL_APP
        d = {n: max_diff(getattr(kernel, n), getattr(plain, n)) for n in ("f", "rho", "u")}
        run = f64_launches(kernel)
        log("double_and_profile", velocity_check=precision,
            shape="x".join(map(str, kernel.domain.shape)), steps=VELOCITY_CHECK_STEPS,
            max_df=d["f"], max_drho=d["rho"], max_du=d["u"], tol=tol,
            plain_calls=kernel._step.plain_calls, max_u=float(kernel.u[0].abs().max()),
            **{f"launches_{k}": v for k, v in run.items() if v})
        if max(d.values()) > tol or kernel._step.plain_calls or not any(run.values()):
            raise RuntimeError(f"sim_2 --velocity res {VELOCITY_CHECK_RES} {precision}: kernel "
                               f"run vs plain run {d} beyond {tol}")
        for k, v in run.items():
            launches[k] += v
        del kernel, plain, runs
        torch.cuda.empty_cache()
        sim = sim2_counted(f"velocity_res8_{precision}", VELOCITY_RES, steps=VELOCITY_STEPS,
                           precision=precision, use_forcing=False)
        ms_step, mlups, peak_gb = run_figures(sim)
        run = f64_launches(sim)
        finite = bool(torch.isfinite(sim.rho).all()) and bool(torch.isfinite(sim.u).all())
        log("double_and_profile", velocity_run=precision,
            shape="x".join(map(str, sim.domain.shape)), steps=sim.iterations,
            ms_per_step=f"{ms_step:.4f}", mlups=f"{mlups:.1f}",
            max_memory_allocated_gb=f"{peak_gb:.3f}", plain_calls=sim._step.plain_calls,
            graph_replays=sim.graph_replays, finite=finite,
            **{f"launches_{k}": v for k, v in run.items() if v})
        if sim._step.plain_calls or not finite or not any(run.values()):
            raise RuntimeError(f"sim_2 --velocity res {VELOCITY_RES} {precision}: plain calls, "
                               f"non-finite output or no launch")
        for k, v in run.items():
            launches[k] += v
        del sim
        torch.cuda.empty_cache()
    return launches


def phase_double_and_profile(floor_gbps: float, f32_l1: dict) -> dict:
    """The float64 instances (B4, B2, B3, B1) and B4's profile instance:
    compares, 256^3 timings, sim_2 res 2 --precision double and sim_2
    --velocity (``f64_compares``, ``f64_timings``, ``sim2_double_runs``,
    ``velocity_runs``).  Returns the record's kernels, errors, times and
    footprints of this slice's keys."""
    import torch

    from tnl_lbm_tpu_torch.kernels.build import build_library, kernel_resources
    from tnl_lbm_tpu_torch.kernels.fused import CudaKernel

    path, ptxas = build_library()
    res = kernel_resources(ptxas)
    names = sorted({n for ns in F64_KERNELS.values() for n in ns})
    f64_ops = sass_fp32_ops(path, names)
    for name in names:
        log("double_and_profile", kernel=name, **res[name], fp32_slots_per_thread=f64_ops[name][0],
            mufu_per_thread=f64_ops[name][1], fp64_slots_per_thread=f64_ops[name][2])
    err = f64_compares()
    timed = f64_timings(floor_gbps, f64_ops)
    launches = sim2_double_runs(f32_l1)
    for k, v in velocity_runs().items():
        launches[k] += v
    torch.cuda.empty_cache()
    sources = {"ab_step_profile": "ab_step.cu", "ab_step_f64": "f64_ab.cu",
               "ab_step_f64_profile": "f64_ab.cu", "aa_even_f64": "f64_aa.cu",
               "aa_odd_f64": "f64_aa.cu", "aa_pair_f64": "f64_pair.cu"}
    replaces = {"ab_step_profile": "tnl_lbm_tpu/kernels/fused.py:585",
                "ab_step_f64": "tnl_lbm_tpu/kernels/fused.py:585",
                "ab_step_f64_profile": "tnl_lbm_tpu/kernels/fused.py:585",
                "aa_even_f64": "tnl_lbm_tpu/kernels/fused_aa.py:408",
                "aa_odd_f64": "tnl_lbm_tpu/kernels/fused_aa.py:287",
                "aa_pair_f64": "tnl_lbm_tpu/kernels/fused_aa.py:1115"}
    kernels = {key: CudaKernel(key, f"tnl_lbm_tpu_torch/csrc/{sources[key]}", replaces[key],
                               launches[key]) for key in F64_KERNELS}
    for key, k in kernels.items():
        if k.launches <= 0:
            raise RuntimeError(f"{key} was not launched on sim_2's float64 or velocity paths")
    resources = {key: {n: res[n] for n in F64_KERNELS[key]} for key in F64_KERNELS}
    err = {key: max(err[key], timed["err"][key]) for key in F64_KERNELS}
    return {"kernels": kernels, "err": err, "times": timed["times"],
            "footprint": timed["footprint"], "resources": resources}


#: the sharded lattice's haloed kernels (csrc/halo_step.cu, f64_ab.cu): record
#: key -> their instances in the library
HALO_KERNELS = {"ab_step_halo": ("ab_halo_cum_well_kernel", "ab_halo_cum_quad_kernel",
                                 "ab_halo_cum_invcum_kernel"),
                "ab_step_f64_halo": ("ab_halo_f64_cum_well_kernel",),
                "aa_odd_halo": ("aa_odd_halo_lean_kernel", "aa_odd_halo_cum_well_kernel",
                                "aa_odd_halo_cum_quad_kernel", "aa_odd_halo_cum_invcum_kernel")}
HALO_REPLACES = {"ab_step_halo": "tnl_lbm_tpu/kernels/fused.py:585",
                 "ab_step_f64_halo": "tnl_lbm_tpu/kernels/fused.py:585",
                 "aa_odd_halo": "tnl_lbm_tpu/kernels/fused_aa.py:287"}
#: sim_2's resolution of the sharded runs (32 x 256 x 256) and their steps
SHARDED_RES, SHARDED_STEPS = 8, 100
#: sim_1's resolution of the sharded A-A run on the 2 x 2 plan (512 x 128 x 128)
SHARDED_SIM1_RES = 4
#: sim_2 res 2 --sharded runs to this time for the start-up check (~9 200 steps)
SHARDED_FINAL_TIME = 10.0


def seeded_cfg_state(cfg, shape, seed=7):
    """cfg's equilibrium of a seeded developed state (rho 1 +- 0.01, |u| ~
    0.02) computed in float64 on the card, in cfg's compute dtype."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rho = 1 + 0.01 * torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float64)
    u = 0.02 * torch.randn((3,) + tuple(shape), generator=gen, device=DEVICE, dtype=torch.float64)
    return cfg.eq(cfg.lat, rho, u).to(cfg.compute_dtype).contiguous()


def card_plan(counts, devices=None):
    """A ShardPlan of prod(counts) shards over x, y, z, every one on the
    card (``devices``: each shard's own)."""
    from tnl_lbm_tpu_torch.parallel.sharded import Mesh, ShardPlan

    grid = np.empty(int(np.prod(counts)), dtype=object)
    grid[:] = devices or [DEVICE + ":0"] * grid.size
    return ShardPlan(Mesh(grid.reshape(counts), ("x", "y", "z")), ("x", "y", "z"))


def sharded_app(app, res: int, streaming: str, plan, label: str, precision="single"):
    """An app's Simulation at ``res`` with the kernels, per step, under
    ``plan`` (None: unsharded), counted from the end of sim_init."""
    from tnl_lbm_tpu_torch.apps import sim_1, sim_2

    where = WORK / "sharded" / label
    if app == "sim_2":
        sim = sim_2.build(res, device=DEVICE, streaming=streaming, use_fused=True,
                          precision=precision, pair_dispatch=False, results_parent=where)
    else:
        sim = sim_1.build(res, device=DEVICE, streaming=streaming, use_fused=True,
                          pair_dispatch=False, results_parent=where)
    sim.plan = plan
    return counting_from_init(sim)


def sharded_step(sim):
    """The kernels' sharded step of a run (inside the uneven step's wrapper)."""
    step = sim._step
    return step if hasattr(step, "exchange") else step.kernels[0]


def halo_launches(sim) -> dict:
    """Launches of the haloed kernels in a sharded Simulation's run."""
    step = sharded_step(sim).local_step
    if hasattr(step, "odd"):
        return {"aa_odd_halo": step.odd.launches, "aa_even": step.even.launches}
    key = "ab_step_f64_halo" if step.kernel.name == "ab_step_f64_halo" else "ab_step_halo"
    return {key: step.kernel.launches}


def sharded_fields(sim):
    """(f, rho, u) of a run, gathered where it is sharded."""
    f = sim.f.gather() if sim.plan is not None else sim.f
    return f, sim.rho, sim.u


def halo_compares() -> dict:
    """Each haloed mode against its plain version on the card, every shard
    of the block, one call from a seeded state: B4 float32 (CUM_WELL on
    sim_2 res 8's map on 2 y-shards; CUM with eq_inv_cum on sim_1 res 2's and
    with eq_quadratic on sim_3 res 2's maps on 2 x 2), B4 float64 (CUM_WELL,
    sim_2 res 8, 2 y-shards), B3's lean instance (sim_2 res 8) and full set
    (sim_1 res 2, 2 x 2).  Returns key -> max |df| (and prints each)."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_1, sim_2, sim_3
    from tnl_lbm_tpu_torch.parallel import sharded as sh

    def domain(app, res, streaming, precision="single"):
        where = WORK / "sharded" / "cmp"
        if app is sim_2:
            s = sim_2.build(res, device=DEVICE, streaming=streaming, precision=precision,
                            results_parent=where)
        elif app is sim_1:
            s = sim_1.build(res, device=DEVICE, streaming=streaming, results_parent=where)
        else:
            s = sim_3.build(res, device=DEVICE, results_parent=where)
        return s.cfg, s.domain

    cases = (("ab_step_halo", "sim_2 res 8 CUM_WELL y2", sim_2, SHARDED_RES, "AB", "single", (1, 2, 1)),
             ("ab_step_halo", "sim_1 res 2 CUM invcum x2y2", sim_1, 2, "AB", "single", (2, 2, 1)),
             ("ab_step_halo", "sim_3 res 2 CUM quad x2y2", sim_3, 2, "AB", "single", (2, 2, 1)),
             ("ab_step_f64_halo", "sim_2 res 8 CUM_WELL f64 y2", sim_2, SHARDED_RES, "AB", "double",
              (1, 2, 1)),
             ("aa_odd_halo", "sim_2 res 8 lean y2", sim_2, SHARDED_RES, "AA", "single", (1, 2, 1)),
             ("aa_odd_halo", "sim_1 res 2 full set x2y2", sim_1, 2, "AA", "single", (2, 2, 1)))
    err = {}
    for key, label, app, res, streaming, precision, counts in cases:
        cfg, dom = domain(app, res, streaming, precision)
        plan = card_plan(counts)
        make = sh.make_sharded_fused_step if streaming == "AB" else sh.make_sharded_fused_step_aa
        step = make(cfg, dom, plan)
        f = plan.shard_field(seeded_cfg_state(cfg, dom.shape), like_f=True)
        halo = step.exchange(f)
        ls = step.local_step
        worst = [0.0, 0.0, 0.0]
        for k in range(plan.n_shards):
            kw = ({"map_arr_in": step.maps.blocks[k]} if streaming == "AB" else
                  {"parity": 1, "map_ring_in": step.rings[k], "bflags": step.bflags[k]})
            uin = (0.01, 0.0, 0.0)
            out = ls(halo[k], NU, u_in=uin, force=(FORCE_SMALL, 0.0, 0.0), **kw)
            plain = ls.plain(halo[k], NU, u_in=uin, force=(FORCE_SMALL, 0.0, 0.0), **kw)
            worst = [max(w, max_diff(a, b)) for w, a, b in zip(worst, out, plain)]
            del out, plain
        tol = (1e-12, 2e-12, 1e-12) if precision == "double" else (TOL_F, TOL_RHO, TOL_U)
        kernel = ls.kernel if streaming == "AB" else ls.odd
        log("sharded", compare=repr(label), kernel=kernel.name, shards=plan.n_shards,
            block="x".join(map(str, ls.shape)), max_df=f"{worst[0]:.3e}",
            max_drho=f"{worst[1]:.3e}", max_du=f"{worst[2]:.3e}", launches=kernel.launches,
            plain_calls=ls.plain_calls)
        if any(w > t for w, t in zip(worst, tol)) or kernel.launches != plan.n_shards \
                or ls.plain_calls:
            raise RuntimeError(f"sharded compare {label}: {kernel.name} against its plain "
                               f"version {worst} beyond {tol}, or not launched once a shard")
        err[key] = max(err.get(key, 0.0), worst[0])
        del step, f, halo
        torch.cuda.empty_cache()
    return err


def halo_reads(lat, codes, w: int, periodic_z: bool, faces=None) -> tuple[int, int, int]:
    """(distinct f elements read, threads, colliding threads) of a haloed
    kernel on this map: ``codes`` is the map at each thread's site, the
    block [X, Y, Z] for the A-B step (w = 1), the block and its 1-wide ring
    [X + 2, Y + 2, Z] for the odd step (w = 2), whose ring sites on the
    block's non-periodic domain faces (``faces``: x low, x high, y low, y
    high) return at once.  A thread pulls one element of each component at
    s - c_q (the odd step: of component opp(q)), so in x and y no two
    threads read the same one and the halo gives only the components that
    point into the threads' sites; a non-periodic z clamps, so two threads
    read the first and last planes; a NOTHING site of the A-B step reads its
    own 27 in place of the pull, one of the odd step's block both
    (``lbm_site.cuh`` ``ab_halo_site``, ``aa_odd_halo_site``; no outflow
    site, whose pulls read x - 1)."""
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    nothing = codes == int(GEO.NOTHING)
    Xt, Yt, Z = codes.shape
    active = np.ones(codes.shape, dtype=bool)
    if faces is not None:
        for flag, edge in zip(faces, (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1])):
            if flag:
                active[edge] = False
    own = nothing if faces is None else nothing[1:-1, 1:-1]
    pulls = active & ~nothing if faces is None else active
    X, Y = own.shape[:2]
    seen = np.zeros((X + 2 * w, Y + 2 * w, Z), dtype=bool)
    total = 0
    for cx, cy, cz in np.asarray(lat.c, dtype=int):
        # thread z reads plane neighbour(z, -cz): mark plane p for every z that reads it
        shifted = np.roll(pulls, -cz, axis=2) if periodic_z or cz == 0 else np.zeros_like(pulls)
        if not periodic_z and cz == 1:
            shifted[:, :, :-1] = pulls[:, :, 1:]
            shifted[:, :, 0] |= pulls[:, :, 0]
        elif not periodic_z and cz == -1:
            shifted[:, :, 1:] = pulls[:, :, :-1]
            shifted[:, :, -1] |= pulls[:, :, -1]
        seen[:] = False
        seen[1 - cx:1 - cx + Xt, 1 - cy:1 - cy + Yt] = shifted  # threads at origin 1
        seen[w:w + X, w:w + Y] |= own
        total += int(seen.sum())
    return total, int(active.sum()), int((active & ~nothing).sum())


def halo_kernel_times(ops: dict) -> dict:
    """The haloed kernels at sim_2 res 8's shard shape on 2 y-shards (block
    32 x 128 x 256, shard 0), each on a seeded state, 20 launches on CUDA
    events (plain: 3 calls), with their bound: the distinct f elements the
    threads read (``halo_reads``, on shard 0's map), the block's writes,
    rho and u, the map at each thread's site, against the FP32 (FP64) slots
    of every thread that collides over the card's issue rates.  Returns key -> (ms, plain ms, bound
    ms, bound_by)."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.parallel import sharded as sh

    out = {}
    for key, streaming, precision, name in (
            ("ab_step_halo", "AB", "single", "ab_halo_cum_well_kernel"),
            ("ab_step_f64_halo", "AB", "double", "ab_halo_f64_cum_well_kernel"),
            ("aa_odd_halo", "AA", "single", "aa_odd_halo_lean_kernel")):
        s = sim_2.build(SHARDED_RES, device=DEVICE, streaming=streaming, precision=precision,
                        results_parent=WORK / "sharded" / "times")
        cfg, dom = s.cfg, s.domain
        plan = card_plan((1, 2, 1))
        step = (sh.make_sharded_fused_step if streaming == "AB"
                else sh.make_sharded_fused_step_aa)(cfg, dom, plan)
        f = plan.shard_field(seeded_cfg_state(cfg, dom.shape), like_f=True)
        halo = step.exchange(f)[0]
        ls = step.local_step
        X, Y, Z = ls.shape
        fout = torch.empty_like(f.blocks[0])
        macro = (torch.empty((X, Y, Z), dtype=fout.dtype, device=fout.device),
                 torch.empty((3, X, Y, Z), dtype=fout.dtype, device=fout.device))
        kw = ({"map_arr_in": step.maps.blocks[0]} if streaming == "AB" else
              {"parity": 1, "map_ring_in": step.rings[0], "bflags": step.bflags[0]})
        ms = time_ms(lambda: ls(halo, NU, force=(FORCE_SMALL, 0.0, 0.0), out=fout,
                                macro_out=macro, **kw), 20)
        plain_ms = time_ms(lambda: ls.plain(halo, NU, force=(FORCE_SMALL, 0.0, 0.0), **kw), 3)
        item = fout.element_size()
        sites = X * Y * Z
        if streaming == "AB":
            reads, threads, colliding = halo_reads(cfg.lat, step.maps.blocks[0].cpu().numpy(), 1,
                                                   bool(dom.periodic[2]))
        else:
            reads, threads, colliding = halo_reads(cfg.lat, step.rings[0].cpu().numpy(), 2,
                                                   bool(dom.periodic[2]),
                                                   ls._faces(step.bflags[0]))
        moved = item * reads + (27 + 4) * item * sites + threads
        per_thread = ops[name]
        b_ms, b_by = bound(moved / sites, tuple(v * colliding / sites for v in per_thread), sites)
        out[key] = (ms, plain_ms, b_ms, b_by)
        log("sharded", timing=key, kernel=name, block=f"{X}x{Y}x{Z}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            bytes_moved=moved, bytes_per_site=f"{moved / sites:.3f}", threads=threads,
            colliding_threads=colliding, f_elements_read=reads, fp32_slots_per_thread=per_thread[0],
            fp64_slots_per_thread=per_thread[2])
        del step, f, halo, fout, macro
        torch.cuda.empty_cache()
    return out


def sharded_runs() -> tuple[dict, dict]:
    """N shards against one on one card: sim_2 res 8 A-B unsharded and on
    1, choose_plan's 2 and 4 and its uneven 3; sim_2 res 8 A-A per step
    unsharded and on 1 and 2; sim_1 res 4 A-A unsharded and on 1 and 2 x 2;
    where the machine has more than one card, each group also over 2 cards
    and over every card.  SHARDED_STEPS steps each through
    ``Simulation._advance`` from rest; the one-shard and the multi-card
    fields held to the unsharded kernels' run, the other one-card runs' to
    the one-shard run's (bit for bit, or the difference printed and within
    the step bounds).  Each run's ms per step, MLUPS, peak memory and, where
    it is sharded, its halo exchange on CUDA events.  Returns the haloed
    kernels' launches and the runs' figures."""
    import torch

    from tnl_lbm_tpu_torch.parallel.sharded import choose_plan

    launches = {k: 0 for k in HALO_KERNELS}
    figures = {}
    cuda0 = DEVICE + ":0"
    n_cards = torch.cuda.device_count()
    cards = [(f"{k} cards", [f"{DEVICE}:{i}" for i in range(k)])
             for k in sorted({2, n_cards}) if n_cards > 1]
    groups = (("sim_2", SHARDED_RES, "AB", (("unsharded", None), ("1", (1, 1, 1)), ("2", 2),
                                             ("4", 4), ("3 uneven", 3), *cards)),
              ("sim_2", SHARDED_RES, "AA", (("unsharded", None), ("1", (1, 1, 1)), ("2", 2),
                                             *cards)),
              ("sim_1", SHARDED_SIM1_RES, "AA", (("unsharded", None), ("1", (1, 1, 1)),
                                                  ("2x2", (2, 2, 1)), *cards)))
    for app, res, streaming, plans in groups:
        kept = {}  # the group's unsharded and one-shard fields
        for name, spec in plans:
            label = f"{app}_res{res}_{streaming}_{name.replace(' ', '_')}"
            sim = sharded_app(app, res, streaming, None, label)
            plan = (None if spec is None else card_plan(spec) if isinstance(spec, tuple)
                    else choose_plan(sim.domain, spec if isinstance(spec, list) else [cuda0] * spec))
            sim.plan = plan
            sim.sim_init()
            sim._advance(SHARDED_STEPS)
            ms_step, mlups, peak = run_figures(sim)
            fields = sharded_fields(sim)
            halo_ms, diffs, against = None, None, None
            if plan is None:
                kept["unsharded"] = fields
            else:
                for k, v in halo_launches(sim).items():
                    if k in launches:
                        launches[k] += v
                halo_ms = time_ms(lambda: sharded_step(sim).exchange(sim.f), 20)
                against = ("unsharded" if name == "1" or isinstance(spec, list) else "one")
                if name == "1":
                    kept["one"] = fields
                diffs = [max_diff(a, b) for a, b in zip(fields, kept[against])]
            figures[label] = {"ms_per_step": ms_step, "mlups": mlups, "peak_gb": peak,
                              "halo_ms": halo_ms, "counts": None if plan is None else plan.counts}
            log("sharded", run=label, plan="unsharded" if plan is None else
                "x".join(map(str, plan.counts)),
                devices="n/a" if plan is None else ",".join(sorted({str(d) for d in plan.devices})),
                steps=sim.iterations, ms_per_step=f"{ms_step:.4f}", mlups=f"{mlups:.1f}",
                max_memory_allocated_gb=f"{peak:.3f}",
                halo_exchange_ms="n/a" if halo_ms is None else f"{halo_ms:.4f}",
                **({} if diffs is None else {"against": against,
                                             "max_df": f"{diffs[0]:.3e}",
                                             "max_drho": f"{diffs[1]:.3e}",
                                             "max_du": f"{diffs[2]:.3e}",
                                             "bit_equal": all(d == 0 for d in diffs)}))
            if diffs is not None and any(d > t for d, t in zip(diffs, (TOL_F, TOL_RHO, TOL_U))):
                raise RuntimeError(f"{label}: {diffs} from the {against} run, beyond the step "
                                   f"bounds")
            if not all(bool(torch.isfinite(t).all()) for t in fields):
                raise RuntimeError(f"{label}: non-finite fields")
            del sim, fields
            torch.cuda.empty_cache()
        del kept
    return launches, figures


def sharded_apps() -> dict:
    """The apps' ``--sharded`` through their ``main``, over the machine's
    cards: sim_2 res 2 A-B (``--scaling strong``) to t = SHARDED_FINAL_TIME,
    its L1 within 5% of the start-up solution at its last probe and equal to
    the unsharded A-B run's there (run here to the same time); then short
    runs of ``--scaling weak_1d`` and ``weak_3d``, ``--precision double``
    A-B, ``--streaming AA``, and sim_1 res 2 (A-B and ``--streaming AA``)
    and sim_3 res 2 ``--sharded``, each through the haloed kernels (launches
    > 0, no plain call).  Returns the haloed kernels' launches."""
    from tnl_lbm_tpu_torch.apps import sim_1, sim_3

    launches = {k: 0 for k in HALO_KERNELS}

    def counted(sim, label):
        ls = sharded_step(sim).local_step
        got = halo_launches(sim)
        for k, v in got.items():
            if k in launches:
                launches[k] += v
        log("sharded", app=label, iterations=sim.iterations, plan="x".join(map(str, sim.plan.counts)),
            **{f"launches_{k}": v for k, v in got.items()}, plain_calls=ls.plain_calls)
        if ls.plain_calls or min(got.values()) <= 0 or sim.nan_detected:
            raise RuntimeError(f"{label}: not through the haloed kernels (or NaN)")

    ref, _ = run_sim2("unsharded_strong", ["--use-fused", "--final-time",
                                          str(SHARDED_FINAL_TIME)])
    ab_l1 = {it: l1 for it, l1, _ in ref.error_history}
    del ref
    sim, wall = run_sim2("sharded_strong", ["--sharded", "--use-fused", "--final-time",
                                            str(SHARDED_FINAL_TIME)])
    it, l1, _ = sim.error_history[-1]
    l1_ref = startup_l1(sim, it)
    rel = abs(l1 / l1_ref - 1)
    same = ab_l1.get(it)
    log("sharded", app="sim_2 res 2 --sharded --use-fused", l1=f"{l1:.6e}", iterations=it,
        wall_s=f"{wall:.1f}", l1_startup_solution=f"{l1_ref:.6e}", rel_to_startup=f"{rel:.2e}",
        l1_unsharded_same_iteration="not probed" if same is None else f"{same:.6e}",
        equal_to_unsharded=same == l1)
    counted(sim, "sim_2 res 2 strong")
    if not rel <= 0.05 or same is None or abs(l1 - same) > 1e-6 * abs(same):
        raise RuntimeError(f"sim_2 --sharded res 2: L1 {l1:e} against the start-up "
                           f"solution's {l1_ref:e} and the unsharded run's {same}")
    for label, args in (("weak_1d", ["--scaling", "weak_1d"]), ("weak_3d", ["--scaling", "weak_3d"]),
                        ("double", ["--precision", "double"]), ("aa", ["--streaming", "AA"])):
        sim, _ = run_sim2(f"sharded_{label}", ["--sharded", "--use-fused", "--final-time", "1",
                                               *args])
        counted(sim, f"sim_2 res 2 --sharded {' '.join(args)}")
    for app, args in ((sim_1, []), (sim_1, ["--streaming", "AA"]), (sim_3, [])):
        sim = app.main(["2", "--device", DEVICE, "--sharded", "--final-time", "0.0005"
                        if app is sim_1 else "0.01", *args, "--results-dir",
                        str(WORK / "sharded" / f"{app.__name__.rsplit('.', 1)[1]}_{len(args)}")])
        counted(sim, f"{app.__name__.rsplit('.', 1)[1]} res 2 --sharded {' '.join(args)}")
    return launches


def phase_sharded() -> dict:
    """The sharded lattice on the card (``halo_compares``, ``halo_kernel_times``,
    ``sharded_runs``, ``sharded_apps``).  Returns the record's kernels,
    errors, times and bounds of the haloed kernels."""
    import torch

    from tnl_lbm_tpu_torch.kernels.build import build_library, kernel_resources
    from tnl_lbm_tpu_torch.kernels.fused import CudaKernel

    path, ptxas = build_library()
    res = kernel_resources(ptxas)
    names = sorted({n for ns in HALO_KERNELS.values() for n in ns})
    ops = sass_fp32_ops(path, names)
    for name in names:
        log("sharded", kernel=name, **res[name], fp32_slots_per_thread=ops[name][0],
            fp64_slots_per_thread=ops[name][2])
    err = halo_compares()
    times = halo_kernel_times(ops)
    launches, figures = sharded_runs()
    for k, v in sharded_apps().items():
        launches[k] += v
    torch.cuda.empty_cache()
    sources = {"ab_step_halo": "halo_step.cu", "ab_step_f64_halo": "f64_ab.cu",
               "aa_odd_halo": "halo_step.cu"}
    kernels = {key: CudaKernel(key, f"tnl_lbm_tpu_torch/csrc/{sources[key]}", HALO_REPLACES[key],
                               launches[key]) for key in HALO_KERNELS}
    for key, k in kernels.items():
        if k.launches <= 0:
            raise RuntimeError(f"{key} was not launched on the sharded paths")
    resources = {key: {n: res[n] for n in HALO_KERNELS[key]} for key in HALO_KERNELS}
    return {"kernels": kernels, "err": err, "times": times, "figures": figures,
            "resources": resources}


def kernel_footprints(ops: dict, b5_bytes: float, b5_ff_bytes: float) -> dict:
    """(bytes per site, (FP32-pipe, SFU) instructions per site) of each
    kernel at its timed 256^3 inputs (B5: 8192 x 2048, as many sites,
    ``b5_bytes`` and ``b5_ff_bytes`` per site from the timed runs' data):
    the bytes it must move (each input read once, each output written once)
    and the SASS count of ``phase_build`` (B5: its CLBM instances, the ones
    timed; the pairs: two of the lean CUM_WELL site updates they share with
    the odd kernel's FLUID/WALL/NOTHING instance, per site; P2: the affine
    passes, a multiply and an add per DF and pass; the slice's kernels:
    their CUM_WELL instances)."""

    def twice(k):
        return tuple(2 * v for v in ops[k])

    affine = (2 * 27 * 20, 0)  # PROBE_PASSES' timed entry: 20 passes
    return {
        "aa_even": (233, ops["aa_even_cum_well_kernel"]), "aa_odd": (233, ops["aa_odd_kernel"]),
        **{f"aa_pair_{s}": (PAIR_BYTES[s], twice("aa_odd_kernel")) for s in STORES},
        "aa_pair_full": (PAIR_BYTES["f32"], twice("aa_odd_kernel")),
        "ab_step": (AB_BYTES, ops["ab_step_cum_well_kernel"]),
        "copy_permute": (232, ops["copy_permute_kernel"]),
        **{f"pair_pipeline_{load}": (216, affine) for load in ("stages", "direct", "ring")},
        "pair_compute_only": (compute_only_bytes(), affine),
        "element_pipeline": (216, (2 * 27 * ELEMENT_TIMED[2], 0)),
        **{name: (216, (0, 0)) for name in ("window_copy", "window_copy_ld4", "window_copy_ld16")},
        "ab_step_sitemajor": (SITEMAJOR_BYTES, ops["ab_step_sitemajor_cum_well_kernel"]),
        "ade_step": (ADE_BYTES, ops["ade_step_clbm_kernel"]),
        "coupled_ab": (COUPLED_BYTES, ops["coupled_cum_well_clbm_kernel"]),
        "coupled_aa_even": (COUPLED_BYTES, ops["coupled_aa_even_cum_well_clbm_kernel"]),
        "coupled_aa_odd": (COUPLED_BYTES, ops["coupled_aa_odd_cum_well_clbm_kernel"]),
        "d2q9_step": (b5_bytes, ops["d2q9_clbm_kernel"]),
        "nn_force": (NN_BYTES, ops[NN_INSTANCES["nn_force"]]),
        **{f"nn_step_{m}": (AB_BYTES, ops[NN_INSTANCES[f"nn_step_{m}"]])
           for m in ("ab", "even", "odd")},
        **{f"{p}_force_field": (FF_BYTES, ops[NN_INSTANCES[f"{p}_force_field"]])
           for p in ("ab_step", "aa_even", "aa_odd")},
        **{f"{p}_macro_only": (MACRO_BYTES, ops[NN_INSTANCES[f"{p}_macro_only"]])
           for p in ("ab_step", "aa_even", "aa_odd")},
        "d2q9_step_force_field": (b5_ff_bytes, ops[NN_INSTANCES["d2q9_step_force_field"]]),
    }


def bound(bytes_per_site: float, ops_per_site: tuple, sites: float | None = None,
          rates: dict | None = None) -> tuple[float, str]:
    """The least time in ms at ``sites`` (256^3 unless given): the bytes
    over the published HBM rate, or the (FP32-pipe, SFU[, FP64-pipe])
    instructions over the card's issue rates (``RATES``), whichever is
    larger."""
    sites = float(np.prod(BENCH_SHAPE)) if sites is None else sites
    t_bytes = bytes_per_site * sites / (HBM_PEAK_GBPS * 1e9) * 1e3
    fp64 = ops_per_site[2] if len(ops_per_site) > 2 else 0
    t_ops = ops_ms(ops_per_site[0] * sites, ops_per_site[1] * sites, rates or RATES, fp64 * sites)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: seconds per phase of this run, by function name (``timed_phases``)
PHASE_SECONDS: dict = {}


def timed_phases() -> None:
    """Wrap every ``phase_*`` function of this module so that its seconds
    add to PHASE_SECONDS, which the last log line reports."""
    import functools

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
        return timed

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = wrap(name[6:], fn)


def main() -> int:
    if not (ROOT / "tnl_lbm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    # the package, and the geometries shared with the tests (tests/torch_cases.py)
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    shutil.rmtree(WORK, ignore_errors=True)
    timed_phases()
    t_start = time.perf_counter()
    device = phase_device()
    built = phase_build()
    hooked_cmp = phase_compare_hooked()
    steps = phase_compare_steps()
    aa_codes_err = phase_compare_aa_codes()
    pairs = phase_compare_pairs(steps["times"])
    phase_build_rest(built)
    ops = built["ops"]
    probe = phase_probes(pairs["times"]["aa_pair_f32"][0], ops)
    floor = gbps(232, probe["times"]["copy_permute"][0])
    ab = phase_compare_ab(steps["times"], floor)
    t_layouts = time.perf_counter()
    layouts = phase_layouts({**steps["times"], **pairs["times"], **ab["times"]}, floor,
                            built["res"])
    t_layouts = time.perf_counter() - t_layouts
    ade_err = phase_compare_ade()
    coupled_err = phase_compare_coupled()
    timed = phase_time_coupled(floor)
    coupled_aa = phase_compare_coupled_aa()
    timed_aa = phase_time_coupled_aa(steps["times"], floor)
    main_path = phase_main_path()
    kernels = main_path["kernels"]
    collisions = phase_collisions(floor, built["res"], ops, built["site_ops"])
    for key, n in collisions["launches"].items():  # the collisions' runs on the main path
        kernels[key] = dataclasses.replace(kernels[key], launches=kernels[key].launches + n)
    t_bench = time.perf_counter()
    bench_launches = phase_bench()
    t_bench = time.perf_counter() - t_bench
    kernels["ab_step_sitemajor"] = layouts["kernels"]["ab_step_sitemajor"]
    k = layouts["kernels"]["aa_pair_full"]  # B1b's launches: the bench entry's and sim_1's
    kernels["aa_pair_full"] = dataclasses.replace(
        k, launches=bench_launches[k.name] + layouts["sim1_dispatch"]["launches"])
    for store in STORES:
        k = kernels[f"aa_pair_{store}"]
        kernels[f"aa_pair_{store}"] = dataclasses.replace(
            k, launches=k.launches + bench_launches[k.name])
    hooked = phase_main_hooked(floor, built["res"])
    kernels.update(hooked["kernels"])
    phase_blunt()
    for name, n in phase_coupled_hooked().items():
        if name in kernels:
            kernels[name] = dataclasses.replace(kernels[name], launches=kernels[name].launches + n)
    t_ibm = time.perf_counter()
    for name, n in phase_ibm().items():  # B4's macro_only and force_field instances
        kernels[name] = dataclasses.replace(kernels[name], launches=kernels[name].launches + n)
    t_ibm = time.perf_counter() - t_ibm
    t_routes = time.perf_counter()
    routes = phase_collision_routes(floor, built["res"], built["site_ops"])
    for name, n in routes["launches"].items():  # the routes' runs on the main path
        kernels[name] = dataclasses.replace(kernels[name], launches=kernels[name].launches + n)
    t_routes = time.perf_counter() - t_routes
    compare_2d_err = phase_compare_2d()
    golden = phase_golden_2d(built["b5_variants"])
    apps_2d = phase_apps_2d()
    timed_2d = phase_time_2d(floor)
    kernels["d2q9_step"] = dataclasses.replace(
        timed_2d["kernel"], launches=golden["step"].launches + apps_2d["launches"]
        + timed_2d["kernel"].launches)
    kernels["d2q9_chunk"] = golden["chunk"]  # the golden row through resident_route
    hooked_2d = phase_hooked_2d(floor)
    kernels["d2q9_step_force_field"] = hooked_2d["kernel"]
    t_dispatch = time.perf_counter()
    phase_dispatch_and_checkpoint()
    t_dispatch = time.perf_counter() - t_dispatch
    f32_l1 = phase_accuracy()
    double = phase_double_and_profile(floor, f32_l1)
    kernels.update(double["kernels"])
    sharded = phase_sharded()
    kernels.update(sharded["kernels"])
    err = {**steps["err"], **pairs["err"], **probe["err"], **ab["err"], **layouts["err"],
           **double["err"], **sharded["err"],
           "d2q9_step": max(compare_2d_err, timed_2d["err"])}
    for key in ("aa_even", "aa_odd"):
        err[key] = max(err[key], aa_codes_err, main_path["err"][key], collisions["err"][key])
    err["ab_step"] = max(err.get("ab_step", 0.0), collisions["err"]["ab_step"])
    for key in ("ab_step", "ade_step", "coupled_ab", "coupled_aa_even", "coupled_aa_odd"):
        err[key] = max(err.get(key, 0.0), main_path["err"].get(key, 0.0),
                       timed["err"].get(key, 0.0), ade_err.get(key, 0.0),
                       coupled_err.get(key, 0.0), coupled_aa["err"].get(key, 0.0),
                       timed_aa["err"].get(key, 0.0))
    for key, e in hooked_cmp["err"].items():
        err[key] = max(e, hooked["err"].get(key, 0.0))
    nn_force_rel = max(hooked_cmp["nn_force_rel"], hooked["nn_force_rel"])
    err["d2q9_step_force_field"] = max(err["d2q9_step_force_field"], hooked_2d["err"])
    for key, e in routes["err"].items():
        err[key] = max(err.get(key, 0.0), e)
    chunk_timing = golden["timing"]
    err["d2q9_chunk"] = chunk_timing["chunk_max_df"]
    times = {**steps["times"], **pairs["times"], **probe["times"], **ab["times"],
             **layouts["times"],
             **timed["times"], **timed_aa["times"], "d2q9_step": timed_2d["time"],
             **hooked["times"], "d2q9_step_force_field": hooked_2d["time"], **double["times"],
             **{k: v[:2] for k, v in sharded["times"].items()},
             "d2q9_chunk": (chunk_timing["chunk_ms_per_launch"], chunk_timing["chunk_plain_ms"])}
    kernels.update(probe["kernels"])
    footprint = kernel_footprints(ops, timed_2d["bytes"], hooked_2d["bytes"])
    footprint.update(double["footprint"])
    record = {"kernels": []}
    for key, k in kernels.items():
        entry = {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                 "launches": k.launches, "max_abs_err": err[key]}
        if key == "d2q9_chunk":  # at the golden sweep's 128 x 32, GOLDEN_CHUNK steps a launch
            bound_ms, bound_by = chunk_timing["chunk_bound_ms"], chunk_timing["chunk_bound_by"]
            entry.update(shape="128x32", steps_per_launch=GOLDEN_CHUNK,
                         path="golden row 1 (Bouzidi) with each chunk one launch of it "
                              "(torch_cases.resident_route); Simulation runs B5 per step",
                         ms_per_step=chunk_timing["chunk_ms_per_step"],
                         sync_floor_ms_per_step=chunk_timing["sync_floor_ms_per_step"],
                         step_ms_per_launch_128x32=chunk_timing["step_event_ms_per_launch"],
                         cluster=chunk_timing["cluster"])
        elif key in sharded["times"]:  # at sim_2 res 8's shard block, the haloed reads
            bound_ms, bound_by = sharded["times"][key][2:]
            r = sharded["resources"][key]
            entry.update(shape="32x128x256 block of 2 y-shards",
                         registers={n: v["registers"] for n, v in r.items()},
                         spill_stores={n: v.get("spill_stores", 0) for n, v in r.items()})
            if key == "ab_step_halo":
                entry["runs"] = sharded["figures"]
        else:
            bound_ms, bound_by = bound(*footprint[key])
        if key == "nn_force":  # |dF| above; its gate is relative to max |F|
            entry["max_rel_err"] = nn_force_rel
        if key.startswith("aa_pair_") and key[8:] in STORES:  # the pair's resources at 256^3
            geo = pairs["geometry"][key]
            entry.update(registers=built["res"][f"{key}_kernel"]["registers"],
                         smem_bytes=geo["smem_bytes"], stages=geo["stages"])
        if key == "nn_force" or key.startswith("nn_step_"):  # the march's resources at 256^3
            geo = built["nn_geometry"]["nn_force" if key == "nn_force" else "nn_step"]
            r = built["res"][NN_INSTANCES[key]]
            entry.update(registers=r["registers"], spill_stores=r.get("spill_stores", 0),
                         smem_bytes=geo["smem_bytes"], seg_len=geo["seg_len"])
        if key in double["resources"]:  # this slice's instances: ptxas per kernel, bound parts
            r = double["resources"][key]
            entry.update(registers={n: v["registers"] for n, v in r.items()},
                         spill_stores={n: v.get("spill_stores", 0) for n, v in r.items()},
                         smem_bytes={n: v["smem"] for n, v in r.items()},
                         bound_bytes_per_site=footprint[key][0],
                         fp64_slots_per_site=footprint[key][1][2])
        if key in COLLISION_KERNELS:  # the family sources' instances (csrc/coll_*.cu)
            entry["instances"] = collisions["instances"][key] + routes["instances"][key]
        if key in ROUTE_KERNELS and key != "aa_pair_full":  # the family instances
            entry["instances"] = routes["instances"][key]
        if key == "aa_pair_full":  # the pair against its least work, its instances
            entry.update(pair_ms=layouts["pair_ms"], pair_bound_ms=bound(*footprint[key])[0],
                         b1_f32_ms_in_turns=layouts["b1_ms"],
                         instances=layouts["instances"],
                         family_instances=routes["instances"][key],
                         auto_256=routes["auto"],
                         full_set_ms_256=layouts["full_set_ms"],
                         sim_1_res8_ms=layouts["sim1_ms"],
                         sim_1_res8_b2_plus_b3_ms=layouts["sim1_b2_b3_ms"],
                         sim_1_res8_mlups=layouts["sim1_dispatch"]["mlups"],
                         sim_1_res8_auto=layouts["sim1_dispatch"]["chose"])
        record["kernels"].append(
            {**entry, "ms": times[key][0], "plain_ms": times[key][1], "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": probe["library"].get(key)})
    total = time.perf_counter() - t_start
    added = probe["window_seconds"] + t_layouts + t_bench
    log("time", total_seconds=f"{total:.1f}", window_probes_seconds=f"{probe['window_seconds']:.1f}",
        layouts_seconds=f"{t_layouts:.1f}", bench_seconds=f"{t_bench:.1f}",
        dispatch_and_checkpoint_seconds=f"{t_dispatch:.1f}", ibm_seconds=f"{t_ibm:.1f}",
        collision_routes_seconds=f"{t_routes:.1f}", build_seconds=f"{built['seconds']:.1f}",
        added_share=f"{added / total:.3f}")
    log("time", **{f"{k}_seconds": f"{v:.1f}" for k, v in PHASE_SECONDS.items()})
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
