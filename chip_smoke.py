#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spark_timeseries_tpu_torch``) on one
NVIDIA card and hold its CUDA kernels against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. ``device``: the card (with ``nvidia-smi``'s name and power limit on a
   line of its own), torch and CUDA versions; TF32 matmuls off.
2. ``build``: nvcc builds every kernel from ``csrc/``, one process per
   source, all started together.  Then the Holt-Winters panel is made and
   four CPU worker processes start refitting 1024 of its lanes in float64
   (they run while the card works; ``hw_path`` reads them).
3. ``kernel_vs_plain``: ``ops.arma_ne.normal_equations`` (the
   series-major CUDA kernel) against ``normal_equations_plain`` in float32 on the card and in
   float64 on the CPU, at the main path's chunk shape; the time-major
   kernel it replaced (``normal_equations_time_major``) against the
   same float32 plain pass.
4. ``main_path``: ``FitEngine().stream_fit`` of a 1,048,576 x 128
   float32 ARIMA(2,1,2) panel in 131072-series chunks on the card, the
   LM-fit kernel's and the single-pass kernel's launches counted over
   exactly that run (one LM-fit launch per chunk, no single pass); then
   4096 of its lanes refitted on the CPU in float64 and compared; then
   one warm chunk's steps timed apart with CUDA events (H2D,
   differencing, Hannan-Rissanen init, the LM-fit kernel, quarantine and
   model build, D2H).
5. ``timing``: CUDA-event times of the single-pass kernel (the
   series-major one; the time-major one it replaced beside it) and of its
   plain version, their bounds, and the LM-fit kernel's time a chunk.
6. ``lm_fit_vs_route``: on the first 131072-lane ARIMA chunk, the LM-fit
   kernel (``ops.arma_ne.fit_css_lm``, a thread a lane; block sizes
   64/128/256) against the batched LM over the single-pass kernel (``fit_css_lm_route``, one launch per iteration,
   its launches counted over that run): both times, per-lane agreement,
   the lanes' passes, the kernel's bounds, its warp efficiency, its
   slowest lane fitted alone, registers and spills of every
   instantiation; then the kernel against ``fit_css_lm_plain`` on the
   card on the chunk's first 256 lanes.
7. ``css_cost_vs_plain``: ``ops.arma_ne.css_cost`` (the cost-only kernel)
   against ``css_cost_plain``, dense and ragged, at the ARIMA chunk shape,
   for AR orders in registers and one past them (the runtime-p form); the
   time-major kernel it replaced against the same float32 plain pass.
8. ``hw_kernel_vs_plain``: ``ops.hw_sse.value_and_grad`` (the one-pass
   Holt-Winters kernel on the caller's rows) against
   ``value_and_grad_plain`` in float32 on the card and in float64 on the
   CPU, and bit for bit on every lane against the time-major kernel it
   replaced (``value_and_grad_time_major``): additive period 12 dense and
   ragged, multiplicative period 12, and period 52.
9. ``hw_path``: ``FitEngine().stream_fit(panel, "holt_winters",
   period=12, model_type="additive")`` over a 1,048,576 x 120 float32
   panel (``bench_suite.py``'s monthly recipe) in 131072-series chunks,
   the box-fit kernel's launches counted over exactly that run (one per
   chunk, and no single-pass launch); ``log_likelihood_css`` of one ARIMA
   chunk's fitted models on the card (the cost-only kernel on a path);
   the float64 CPU refit compared by objective.
10. ``hw_timing``: the one-pass Holt-Winters kernel against the
   time-major one at the four cases of ``hw_kernel_vs_plain``: CUDA-event
   times in turns, device times from one fresh profiler session, the
   ``value_and_grad`` call against the time-major call (the panel copied
   per call), the call's initial components and copy apart, each case's
   bound and share, registers, spills, resident lanes and waves of every
   instantiation; then the cost-only ARMA kernel (three orders: two with
   the AR order in registers, one in the runtime-p form; series-major,
   the time-major one beside it); plain versions and bounds.
11. ``hw_fit_vs_solver``: on the first 131072-lane Holt-Winters chunk,
   the box-fit kernel (``ops.hw_sse.box_fit``, block sizes 64/128/256)
   against the batched solver over the single-pass kernel
   (``minimize_box(hw_sse.evaluator(inp))``, one launch per trial, its
   launches counted over that run): both times, per-lane agreement, the
   lanes' evaluations, the kernel's operation bound, its warp efficiency
   and its slowest lane fitted alone; then the kernel against
   ``box_fit_plain`` on the card on the chunk's first 256 lanes.
12. ``auto_fit_path``: ``models.arima.auto_fit_panel(panel, max_p=5,
   max_d=2, max_q=5)`` on a 131072 x 128 float32 panel
   (``synthetic_arima_panel`` at seed 3, the JAX package's auto-fit bench
   panel at one chunk's size), once warm: its screen must be exactly one
   LM-fit launch per candidate (C = 36) and its refine one, C + 1 in all,
   and no single pass; CUDA-event times of KPSS, the HR init, the screen
   (the span of its call, its launches on side streams joined back) and
   the refine; the orders
   histogram, the share of each d, the share of winners whose screen hit
   its cap; the orders and coefficients of the first 256 series against a
   float64 CPU run of the same function (a spawned process started after
   the build).
13. ``auto_grid_vs_route``: the LM-fit kernel in grid mode at the
   screen's full inputs (36 x 131072 lanes over the unrepeated panel):
   the screen's launch per candidate at its own order and the padded
   single launch at (5,5,1), timed in turns and held against each other
   (equal ``n_iter`` and ``fun`` shares, max |Δx|), the screen's time
   beside the sum of each candidate's launch timed alone (with that
   candidate's op bound, residency, registers and spills); each lane
   whose x differs between the two traced to the first iteration where
   they part and the padded normal equations at the point before and at
   the trial point; the op
   bound from the lanes' passes, warp efficiency and slowest lane alone; on the lanes of the first 4096
   series against ``fit_css_lm_route`` (the panel repeated 36 times, one
   ``arma_ne`` launch per iteration), and on those of the first 64
   against ``fit_css_lm_plain`` in float32 on the card.
14. ``panel_path``: the ``Panel`` tier on the card.  ``io.save_csv`` then
   ``io.load_csv`` of a 131072 x 128 float32 panel (one chunk, ~0.3 GB
   of text) through the native codec (it must be the native one), bit
   for bit; a ``Panel`` of the main path's 1,048,576 x 128 panel on a UTC
   business-day index with gaps from ``--seed`` (1 % of each series'
   observations knocked out inside its window, 5 % of the series starting
   1-16 steps late), its H2D timed; ``fill("linear")`` on the card (CUDA
   events) against the port's float32 CPU fill of the first 131072 rows;
   ``Panel.stream_fit("arima", p=2, d=1, q=2)`` in 131072-series chunks,
   the LM-fit kernel's launches counted over exactly that run (one per
   chunk, ragged lanes included, no single pass), its ``n_converged`` and
   first chunk's coefficients against ``FitEngine().stream_fit`` of the
   same filled values from the host, and its series/s with the panel's
   D2H apart; the first chunk staged as ``arima.fit`` stages it (ragged
   lanes left-aligned, differenced, their Hannan-Rissanen init over each
   window) refitted by the LM-fit kernel's ragged form, whose result
   must be the coefficients the path collected, against
   ``fit_css_lm_route`` on every lane and on the ragged lanes alone, and
   against ``fit_css_lm_plain`` on 128 ragged and 128 dense lanes, held
   to ``lm_fit_vs_route``'s floors; ``Panel(auto panel).auto_fit()`` at the default grid, its
   C + 1 = 37 launches counted, its orders and coefficients against
   ``auto_fit_panel`` of the same values, bit for bit.

15. ``resilient_path``: the fail-soft fit.  The main path's panel with
   pathological rows from ``--seed`` (0.2 % each all-NaN, constant, with
   an inf, with an interior gap, too short; 5 % healthy late starts)
   through ``FitEngine().stream_fit(resilient=True, retry=RetryPolicy(),
   auto_order=True)`` in 131072-series chunks, the kernels' launches
   counted over exactly that run (the LM-fit kernel's must equal the
   stages' own count, no single pass); statuses, attempts histogram,
   launches and restarted lanes per chunk, the share of usable lanes;
   then its first chunk bitwise against ``arima.fit_resilient`` and
   ``Panel.fit_resilient`` of the same rows, its OK lanes bitwise against
   the plain ``arima.fit``, its health codes bitwise against the CPU's
   ``classify_series`` (skipped lanes NaN with 0 attempts), and on 4096
   retried lanes the restart loop over the LM-fit kernel against the
   same loop over ``fit_css_lm_route`` with the same draws.
16. ``arima_surface``: on the main panel's first chunk and its fit,
   ``forecast_interval``, ``approx_aic`` (the cost-only kernel once),
   ``gradient_log_likelihood_css_arma`` (the single pass once, against
   its plain version), ``coefficient_precision``, the time-dependent
   effects and the residual tests, ``adftest``, KPSS ``"ct"``,
   ``refit_unconverged`` (one LM-fit launch) and the stepwise
   ``auto_fit`` of single series, each timed with CUDA events and held
   against the port's float64 CPU run on 256 lanes; the widths of the
   one-pass launches (power-of-two buckets).
17. ``vol_path``: GARCH, AR-GARCH and EGARCH (no kernel: plain PyTorch,
   EGARCH's derivative pass replayed from a CUDA graph) on a 65,536 x
   1024 panel from BASELINE config #4's generator (``--seed``), each
   ``FitEngine().stream_fit`` in 16384-series chunks: series/s,
   ``converged_pct``, wall per chunk, iterations; ``Panel.stream_fit``
   of the first chunk bitwise the stream's; the first chunk with 0.2 %
   each all-NaN, constant, inf and too-short rows through
   ``FitEngine.fit_resilient`` (skipped = the unfittable rows, health =
   the CPU's, OK lanes = the plain fit of the same rows, bitwise); the
   first 256 lanes' float64 neg-LL at the card's parameters against
   float64 CPU fits (two spawned processes started before
   ``panel_path``), floor 0.90 within 1e-5.  For EGARCH the resilient
   chunk runs again under a ``force_nonconverge`` fault that fails
   every Newton attempt, so that the descent stage runs on every
   fittable lane: its seconds and peak memory, every fittable lane at
   the constant stage, and the descent's lanes among the first 256
   against the float64 CPU Newton optimum (floor 0.90 within 3e-3).
18. ``ewma_path``: ``FitEngine().stream_fit(values, "ewma")`` of a
   1,048,576 x 128 random-walk panel (BASELINE config #1's recipe) in
   131072-series chunks; the first 1024 lanes against a float64 CPU
   fit, floor 0.90 within 1e-4.
19. ``hw_resilient_path``: the Holt-Winters panel with 0.2 % each
   all-NaN, constant, inf and too-short (20 steps) rows through
   ``stream_fit(resilient=True, retry=RetryPolicy())``: statuses,
   attempts, usable share beside ``hw_path``'s ``converged_pct``,
   ``hw_box_fit`` launches = the stages' count and no ``hw_sse``; its
   first chunk bitwise ``holt_winters.fit_resilient`` and
   ``Panel.fit_resilient``; the restart driver over ``hw_box_fit``
   against the one over ``minimize_box`` over ``hw_sse`` on the first
   4096 healthy lanes at a 30-iteration budget (so that many restart),
   with the same draws (floors 0.95, 0.95).
20. ``css_cgd_path``: ``arima.fit(2, 1, 2, chunk, method="css-cgd")``
   on the first 131072-series chunk: ms, ``arma_ne`` launches =
   ``stats["ne_launches"]`` and their widths, BFGS iterations, ``converged_pct`` (no
   floor); the share of lanes whose neg-LL is within 1e-4 of the css-lm
   fit's (floor 0.90, held after the kernels line), with the shares
   where css-cgd ends worse or better; on 256 lanes the BFGS over
   ``arma_ne`` against the BFGS over the plain pass, both on the card
   (fun within 1e-5, floor 0.90).
21. ``regarima_path``: BASELINE config #5 (``bench_suite.py:365-375``'s
   generator at 131,072 x 256: three shared random-walk regressors, AR(1)
   errors at 0.6): ``regression_arima.fit_cochrane_orcutt(y, X, 10)``,
   ``stats.adftest(y, 4)`` and ``stats.kpsstest(y, "c")``: series/s,
   Cochrane-Orcutt rounds; against the port's float64 CPU run of the
   first 256 lanes (the same stopping decision, floor 0.95; β and ρ
   within 1e-3 of the lane's largest entry, floor 0.90; ADF and KPSS
   within 1e-3, floor 0.99); the first 16384 rows with 0.2 % each
   all-NaN, constant, inf and too-short rows through
   ``FitEngine().fit_resilient`` (skipped = the unfittable rows, health
   = the CPU's, OK lanes = the plain fit, Panel = the engine, bitwise).
22. ``arimax_path``: ``arimax.fit(2, 1, 2, chunk, X, 1)`` (css-lm) of
   each 131072-series chunk of the north-star panel plus ``X @ β`` (two
   shared random walks from ``--seed``): one ``arma_lm_fit`` launch a
   chunk and no ``arma_ne``; the first chunk's refine against
   ``fit_css_lm_route`` on the same adjusted series and starts (floors
   0.95); the model's CSS likelihood and gradient (one ``arma_css``
   and one ``arma_ne`` launch); the first 256 lanes against a float64
   CPU fit by objective (floor 0.90 within 1e-5); the first chunk with
   pathological rows through ``fit_resilient(..., retry=RetryPolicy())``
   (launches = the stages' count and the ``arma_ne`` launches' widths,
   OK lanes = the plain fit, bitwise).
23. ``exact_path``: ``arima.fit(2, 1, 2, chunk, objective="exact")`` on
   the first 131072 series (one ``arma_lm_fit`` launch, then BFGS on the
   Kalman likelihood): seconds, iterations, calls, kernels a
   value-and-gradient evaluation (``torch.profiler``), peak memory;
   every finite lane's exact log likelihood at least its CSS start's;
   256 lanes against the float64 CPU exact fit (floor 0.90 within
   1e-5); ``log_likelihood_exact`` against float64 on 4096 lanes (floor
   0.99 within 1e-4 on the stationary, invertible ones).  The float64
   CPU fits of 22 and 23 run in two spawned processes started before
   ``ewma_path``.
24. ``serving_path``: the online serving tier (``statespace.serving``),
   float32.  An ARIMA(2,1,2)+c ``ServingSession`` over the north-star
   panel's first 131072 series (``arima.fit`` on the first 64 columns,
   one ``arma_lm_fit`` launch; the last 64 columns are live ticks):
   ``start``, ``warmup``, 64 ``update`` calls (p50 / p95 ms of the
   ``serving.update`` span, which copies each TickResult to the host;
   the device operations of one tick by ``torch.profiler``;
   ``state_bytes``), ``update_batch`` of the same ticks on a second
   session bitwise the single updates, ``forecast(24)``; v, F,
   statuses and forecasts of the first 256 lanes against the port's
   float64 CPU session (floor 0.99 of the lanes whose fitted model is
   stationary and invertible within 1e-3 of each lane's largest entry,
   and of equal statuses; the shares over all 256 reported); the same
   tick at 1024 series (``bench.py``'s serving width); an additive
   Holt-Winters session (period 12, the Holt-Winters panel's first
   131072 series, 104 columns of history, one ``hw_box_fit`` launch, 16
   ticks) held the same way; ``heal()`` of a private-registry session with
   ``state_poison`` on 8 lanes (stride S // 8): every poisoned lane
   healed, ``arma_lm_fit`` launches = the refit chain's own count, the
   untouched lanes bit for bit, its ms; a session with
   ``QualityPolicy()`` (48 ticks: ms a tick, drift alarms, online sMAPE
   and MASE against float64 on 256 lanes, floor 0.99); checkpoint and
   restore on the card, the next tick bitwise.
25. ``ne_rows_timing``: the series-major one-pass kernels
   (``arma_ne_rows_kernel``, ``arma_css_rows_kernel``) against the
   time-major ones they replaced, at (2,1,2)+c on the differenced chunk
   (``n_obs`` 127), dense and ragged, at S = 131072 and the median and
   90th-percentile widths of the launches of 16, 20 and 22: every lane
   bit for bit; CUDA-event medians in turns (old, new, new, old) of each
   kernel alone and of each call (``normal_equations``,
   ``css_neg_ll_value_and_grad``, ``css_cost``), new against old; the
   bounds; the device operations of one call (``torch.profiler``: the
   runtime calls that put work on the card), one for
   ``normal_equations`` and for ``css_cost``.
26. ``long_path``: the long-series tier (``longseries``), float32.  A
   10⁶-observation ARMA(1,1) (``bench.py``'s long demo: ε from seed 11,
   the AR part through ``ops.scan_parallel.ar1_filter``) through
   ``longseries.fit_long(series, order=(1, 0, 1))``'s default fused path
   (122 segments of 8192): fit seconds, obs/s, ``forecast(24)`` seconds
   with the origin recovery; π₁ within 0.05 of 1.0; ``arma_lm_fit``
   launches = the segment chunks = ``stream_stats["lm_fit_launches"]``,
   no one-pass launch; ``longseries.fused_bytes_d2h`` =
   ``expected_combine_acc_bytes(12)``.  ``fused=False`` (the staged
   ``stream_fit`` path): every segment's coefficients bit for bit the
   fused path's, the combined ones within 1e-6.  The LM-fit kernel at
   that shape (122 lanes x 8192 steps): CUDA-event ms, passes, bound;
   against ``fit_css_lm_plain`` on the card at 2 iterations (fun within
   1e-3 on ≥ 0.95 of lanes).  ``auto=True``: seconds, the histogram of
   segment orders, launches = ``stats["lm_fit_launches"]`` = 37.  10⁸
   observations (generated on the card; 1525 segments of 65536, 3 fused
   chunks): fit seconds, obs/s, the forecast origin's seconds and peak
   memory, launches = chunks, π₁.  ``models.arima.fit_long(2, 1, 2)``
   at ``bench_suite.py``'s shape (8 x 262,144, seed 7, segments of
   16384) against the direct ``arima.fit``: the first series'
   coefficients within 0.05, obs/s of both, the segment Hessians'
   seconds.  The series' first 131,072 observations at ``seg_len`` 8192
   against the port's float64 CPU run (a spawned process started at the
   phase's start): combined coefficients within 1e-3, ``forecast(24)``
   within 1e-3 of max(1, |f|), and the float64 forecast off the
   recovered origin against the statespace filter run step by step over
   the whole span within 1e-7.  The LM-fit kernel against
   ``fit_css_lm_plain`` (float32, on the CPU in spawned processes, from
   the same starts, 2 iterations) on 8 lanes of the 10⁸ fit's 65536-step
   segments and 8 of ``arima.fit_long``'s 16384-step (2,2) segments:
   ``fun`` within 2·n·6e-8 on ≥ 0.95 of lanes, its largest gap.
27. ``backtest_path``: rolling-origin backtesting (``backtest``),
   float32.  ``bench.py``'s backtest demo (48 series x 768: AR(1),
   ARMA(1,1), SES; the grid ar(1), ar(2), arima(1,0,1), ewma; horizons
   1, 2, 4; 127 origins, stride 2, fit window 512): champion sMAPE /
   MASE, true-model recovery, coverage; against the port's float64 CPU
   sweep: equal champions on ≥ 0.95 of series, champion scores within
   1e-3 relative; ``arma_lm_fit`` launches = the ARIMA candidate's
   chunks.  The same panel widened to 131,070 series (3 x 43,690):
   seconds, series x candidates / s, the fit, replay and scoring spans'
   seconds, launches = the ARIMA candidate's chunks, no ``arma_ne``; the
   LM-fit kernel against the plain LM on 8 lanes of its 512-step fit
   window (as in 26).
   The pinned-gain replay against the ``"refilter"`` oracle on 256
   lanes (32 origins, stride 8): forecasts within 1e-4 of max(1, |f|).
   The long route: a 2 x 524,288 panel with a 500,000-step fit window
   at the default ``long_threshold``: the ARIMA candidate takes the
   ``longseries`` path, one ``arma_lm_fit`` launch a series.
28. ``fleet_path``: the fleet (``statespace.fleet``,
   ``statespace.runtime``), float32.  F1: 256 ARIMA(2,1,2)+c tenants of
   512 series (the north-star panel's first 131072, 32 columns of
   history, one coalescing group; the model fitted once at the tenant's
   width, one ``arma_lm_fit`` launch, as ``bench.py:942``) and 16
   additive Holt-Winters tenants (period 12, one ``hw_box_fit``
   launch) under ``AdmissionPolicy(queue_depth=4)``; ``warmup``; a
   ``FleetRuntime`` with a ``checkpoint_dir`` through 32 rounds of
   blocking ``submit`` and ``quiesce``: lane-ticks/s, each coalesced
   dispatch's tick wall and whole call (p50 / p95, first, warm), the
   device operations of one coalesced dispatch (runtime records, as
   ``ne_rows_timing``'s count) beside a solo tick's, lineage e2e p50 /
   p95, ``fleet.pump_restarts`` = ``fleet.shed_lanes`` = 0; 8 tenants'
   ticks bitwise those of solo sessions; ``stop()`` and a fresh
   runtime's ``restore_latest()``: every tenant bitwise, and the next
   tick; ``drain`` with two queued ticks and ``adopt``, bitwise.  F2:
   ``bench.py:925-927``'s 64 tenants of 16 series (its own fit), 16
   rounds, every tenant bitwise its solo session, then 8 rounds under
   ``pump_crash`` (restarts >= 1, every tick delivered once, none
   open).  A child process on the card drains a tenant with two queued
   ticks under ``drop_tenant_process`` (``kill -9`` after the commit);
   this process adopts the bundle bitwise.  Peak memory; launches.
29. ``durable_path``: the engine's durability tier, float32.  The
   north-star panel through ``stream_fit`` journal-free and with a
   journal: series/s of both, the digest's and the commits' seconds, 8
   commits, 8 ``arma_lm_fit`` launches each, the journaled models bitwise
   the plain ones.  On its first 4 chunks, each case bitwise the plain
   run's models: ``oom_chunk`` at chunk 2 (two 65536-lane sub-chunks, 5
   launches; the resume restores 4 chunks, 0 launches); ``hang_chunk``
   at chunk 1 under a 2 s deadline, which hangs every attempt as in the
   JAX engine (two expiries, one retry after the abandoned worker ends,
   one dead chunk, the other three bitwise); ``corrupt_journal`` at chunk 1
   (the resume quarantines the entry and refits 1 chunk); a child on the
   card under ``kill_after_chunk`` at chunk 1 (exit -9, 2 markers, its
   incident bundle; the resume here restores 2 and refits 2); a child
   that caps its allocator between one chunk's peak at half and at full
   width (a real ``torch.cuda.OutOfMemoryError`` halves chunks; no raise,
   no dead chunk).  Holt-Winters (2 chunks, a corrupt entry): the resume
   refits 1 chunk, bitwise.  ``longseries.fit_long`` of 10⁶ observations
   with ``fused=False`` and a journal, and ``backtest_panel`` of
   ``bench.py``'s 48 x 768 demo with a journal: the second call restores
   every chunk, its results bitwise.  ``ops.decompose`` (period 12) of
   the Holt-Winters panel and ``ops.detect_anomalies`` of the north-star
   panel against its one-step fitted values, full width: CUDA-event ms;
   the first 256 rows against the port's float64 CPU run within 1e-5 of
   the lane's scale, flags equal wherever the float64 score is more than
   1e-4 from the threshold.
30. ``obs_path``: the compile tier and the host observability planes.
   Two fresh ``python -m spark_timeseries_tpu_torch.engine --families
   arima,holt_winters --shapes 131072x128 --serving --cache-dir D``
   processes on a copy D of the build directory without the ``hw_sse``
   library: the cold one builds that library alone (``kernels.builds``
   1), the warm one nothing (0); seconds and reports of both.  While the
   cold one compiles (one nvcc process on the host), two fresh
   processes stream the north-star panel's first 4 chunks, one unwarmed
   (its first and second streams), one after ``FitEngine.warmup(
   ("arima",), [(131072, 128)], bucket=False)``: the first streams'
   series/s, their models bitwise equal, the engines' ``cache_stats``.
   Here: the telemetry exporter on a free port while the north-star
   ``stream_fit`` runs 4 times in turns (A B B A, B scraped every 50 ms
   on ``/metrics``, ``/snapshot.json``, ``/healthz`` and ``/trace.json``):
   every scrape answers 200 and parses (the Prometheus grammar, JSON),
   the job's row ends ``done`` with 8 chunks, 8 ``arma_lm_fit`` launches
   a stream; the scraped stream's span events written with
   ``utils.tracing.write_trace`` to ``chiprun_out/obs_path_trace.json``
   and its ``self_time_report(10)`` printed; one warm chunk under
   ``utils.observability.profile``: its trace file, and its one
   ``arma_lm_fit`` launch counted from the runtime records inside the
   launch's profiler range; a ``hang_chunk`` dead chunk's incident
   bundle, schema-valid, its ``trace`` member holding the stream's spans.

Then one line of per-kernel numbers (``launches`` counted over the main
paths' runs, ``launches_by_path`` per run; for a kernel that only a
comparison route launches, ``route_launches`` beside it; the time-major
one-pass kernels, which only the comparisons launch, with
``comparison_only``, their launches counted over the path phases, each
run with their counts set to 0 just before it, and checked to be 0, and
their errors against the same plain passes as the series-major
kernels'; ``obs_path``'s launches include those its child processes
report), a summary line per phase (its seconds and headline figure), the
card's name and power limit, the css-cgd floor's check and, last, the
result line.  Every JSON line also goes to
``chiprun_out/chip_smoke_rows.jsonl``.  Any failed check raises, so the
script prints the summary of the phases before it, exits non-zero and
prints no result line; without CUDA it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

N_SERIES = 1_048_576     # the bench's north-star panel
N_OBS = 128
CHUNK = 131072           # series per chunk, as the JAX bench streams them
N_REFIT = 4096           # lanes refitted on the CPU in float64
HW_N_OBS = 120           # monthly Holt-Winters panel: bench_suite.py:339
HW_PERIOD = 12
HW_N_REFIT = 1024        # Holt-Winters lanes refitted on the CPU in float64
HW_REFIT_WORKERS = 4     # CPU processes sharing that refit
HW_F64_LANES = 16384     # lanes of the float64 CPU kernel reference

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# kernel vs plain: normalized errors (see _ne_errors).  float32 sums over
# <= 127 steps carry a relative rounding of ~127 * 6e-8 = 8e-6 at worst
# per accumulator; the kernel contracts a*b+c into FMAs where the plain
# loop rounds twice, so neither side is exact and 1e-4 bounds both
NE_TOL = 1e-4

# f32-on-card vs f64-on-CPU fits: the float32 LM stops at a relative SSE
# drop of 1e-6 (float64 at 1e-10), so along the CSS surface's flat
# common-factor directions float32 coefficients sit ~1e-3 from the
# float64 optimum (the JAX package's two float32 LM solvers differ by a
# median 8e-4 in tests/test_pallas_arma.py, Pallas against XLA).
# A wrong kernel or solver moves lanes by far more, so: at least 40% of
# lanes converged in both agree to 1e-3 and at least 90% to 5e-3.
AGREE = ((1e-3, 0.40), (5e-3, 0.90))

# cost-only kernel vs plain: relative sse error.  The same float32 sums
# as NE_TOL's over <= 127 steps, so the same bound
CSS_TOL = 1e-4
# orders of the cost-only kernel that hw_timing times: the main path's,
# the largest AR order in registers, one past them (the runtime-p form)
CSS_TIMED = ((2, 2, 1), (5, 0, 1), (8, 1, 1))

# Holt-Winters kernel vs plain: sse relative to itself, each gradient
# entry relative to the larger of its lane's largest and its SSE.  Float32
# alone moves these far on ill-conditioned lanes: the plain loop in
# float32 against float64 (CPU, the first chunk of this panel at random
# parameters) reaches 1.4e-4 on the sse, and on the gradient 2.9e-4 at
# the 99.9th percentile and 4.9e-3 at worst, on lanes with a small alpha and
# beta, gamma near 1, whose tangent recurrences amplify rounding.  The
# kernel differs from the plain loop by FMA contraction and the order of
# the tangents' unit-vector terms, so it is held to float32's own spread:
# the sse and 99.9% of gradient entries within HW_TOL, every gradient
# entry within HW_TOL_ALL.  A wrong recurrence is off by O(1)
HW_TOL = 1e-3
HW_TOL_ALL = 2e-2

# f32-on-card vs f64-on-CPU Holt-Winters fits: the float32 box solver
# stops when a step no longer moves x or f in float32 (its 1e-10
# tolerance is below float32's resolution), the float64 one at a relative
# SSE change of 1e-10 or its 1000-iteration cap; fits sit along flat
# directions, so objectives are compared, not parameters: of the lanes
# converged in both, at least 90% must have a card SSE (re-evaluated in
# float64 at the card's parameters) within 1e-3 relative of the float64
# fit's.  A wrong kernel or solver leaves far more lanes off than that
HW_AGREE = (1e-3, 0.90)

# box-fit kernel vs the batched solver over the single-pass kernel, per
# lane: the same pass and the solver's arithmetic in the solver's order, so
# lanes may part only where a reduction or a contraction rounds otherwise.
# Shares of lanes with the same iteration count, and with an objective
# within 1e-5 relative (tests/test_torch_cuda.py holds the same floors)
HW_SOLVER_SHARE = (0.95, 0.95)
# ... and vs the plain box fit (float32 on the card).  The plain pass
# rounds otherwise on every step (no FMA, its own order of the tangent
# terms), so in float32 most lanes part from it near the end of their fit,
# where Armijo decisions and the stall test turn on the last bits of f:
# their iteration counts differ though they reach the same optimum.  The
# batched solver over the single-pass kernel parts from the plain fit the
# same way, so the kernel is held to it: its shares against the plain fit
# at most HW_PLAIN_MARGIN below the solver route's (the kernel and that
# route part on at most 1 - HW_SOLVER_SHARE of lanes)
HW_PLAIN_MARGIN = 0.1
HW_PLAIN_LANES = 256     # lanes of the plain box fit on the card
HW_TIMING_REPS = 10      # CUDA-event reps a turn in hw_timing
HW_FUN_RTOL = 1e-5

# LM-fit kernel vs the batched LM over the single-pass kernel, per lane:
# the same pass and the LM loop's arithmetic in the loop's order, so
# lanes may part only where a contraction or a reduction rounds
# otherwise.  Shares of lanes with the same iteration count, and with an
# objective within 1e-5 relative (tests/test_torch_cuda.py holds the same
# floors)
LM_ROUTE_SHARE = (0.95, 0.95)
# ... and vs the plain LM (float32 on the card): the plain pass rounds
# otherwise on every step (no FMA), so float32 fits part from it near
# their end, where the accept and stop tests turn on the last bits of f.
# The route parts from it the same way, so the kernel is held to it: its
# shares at most LM_PLAIN_MARGIN below the route's
LM_PLAIN_MARGIN = 0.1
LM_PLAIN_LANES = 256     # lanes of the plain LM on the card
LM_FUN_RTOL = 1e-5

# the card's CSS log likelihood vs float64 on invertible converged lanes:
# a float32 sum of <= 127 squares is good to ~1e-6 relative and the log
# likelihood inherits that; 1e-5 leaves room for FMA contraction
LL_TOL = 1e-5
HW_CONVERGED_FLOOR = 90.0

# the batched auto-ARIMA: the default grid (36 candidates) on the JAX
# package's auto-fit bench panel (bench.py:190, bench_suite.py:390) at
# one chunk's size
AUTO_N_SERIES = 131072
AUTO_SEED = 3
AUTO_GRID = dict(max_p=5, max_d=2, max_q=5)
AUTO_N_REF = 256          # series refitted on the CPU in float64
# float32 on the card against float64 on the CPU: close AICs may rank
# otherwise, and float32 coefficients sit ~1e-4-1e-3 from the float64
# optimum along flat directions (the JAX package's own float32 and float64
# auto-fits of this panel chose the same (p, d, q) on 98.4 % of series,
# with a median max |Δcoef| of 9e-5 where they did).  A wrong kernel or
# gather moves far more series
AUTO_ORDERS_FLOOR = 0.90
AUTO_COEF_MEDIAN = 1e-3
AUTO_ROUTE_SERIES = 4096  # series whose 36 lanes the route refits
AUTO_PLAIN_SERIES = 64    # series whose 36 lanes the plain LM refits
GRID_TRACE_LANES = 64     # lanes of the screen traced where x differs

# the Panel tier: gaps of the 1M-series panel (the mix from_observations
# and union make of real feeds), the CSV round trip at one chunk's size,
# and the rows of the card's fill held against the CPU's
PANEL_GAP_SHARE = 0.01    # observations knocked out inside each window
PANEL_LATE_SHARE = 0.05   # series starting late
PANEL_LATE_MAX = 16       # ... by 1 to this many steps
PANEL_CSV_SERIES = 131072
PANEL_FILL_CPU_ROWS = 131072
# card fill vs the CPU's float32 fill: each step is one correctly rounded
# op on both (the card's division is IEEE, not approximate), so they are
# expected equal bit for bit; where they are not, a value may differ by a
# rounding of its interpolation step, 2 float32 ulps relative
FILL_RTOL = 2.0 ** -22

# the resilient phase's pathological rows, drawn from --seed: this share
# of the panel each all-NaN, constant, with an inf, with an interior gap,
# and too short (a valid window of RES_SHORT_WINDOW); RES_LATE_SHARE of the
# series start 1 to RES_LATE_MAX steps late (healthy, ragged)
RES_SHARE = 0.002
RES_SHORT_WINDOW = 8
RES_LATE_SHARE = 0.05
RES_LATE_MAX = 16
RES_ROUTE_LANES = 4096   # retried lanes: restart loop over kernel / route
# arima_surface: lanes of the port's float64 CPU run each method is held
# against, the relative tolerance of float32 on the card against float64
# on identical coefficients (~1e-6 per rounding, grown over the 127-step
# recurrences and their sums), and the share of stationary and invertible
# lanes that must meet it (an explosive lane's recurrence amplifies the
# last bits of its inputs without bound)
SURF_CPU_LANES = 256
SURF_RTOL = 1e-3
SURF_SHARE = 0.99
SURF_GRAD_JITTER = 0.05   # sd of the jitter the gradient is taken at
SURF_AUTO_SERIES = 8      # stepwise auto_fit: series, share of equal orders
SURF_AUTO_FLOOR = 0.75


# every JSON row also goes to this file (a long run's output may be kept
# only in part), and each phase's row to the summary printed last
ROWS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chiprun_out", "chip_smoke_rows.jsonl")
_SUMMARY = []
_FAILURES = []
_T_START = time.perf_counter()

# each phase's headline figure: the first of these its row holds
_HEADLINES = (("exporter", "scraped_over_plain"), ("series_per_s",),
              ("whole", "plain_series_per_s"), ("lane_ticks_per_s",),
              ("tick", "p50_ms"), ("kernel_ms",), ("lm_fit_ms",),
              ("box_fit_ms",), ("seconds",))


def _headline(obj):
    for path in _HEADLINES:
        v = obj
        for key in path:
            v = v.get(key) if isinstance(v, dict) else None
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return "/".join(path), v
    return None, None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(os.path.dirname(ROWS_FILE), exist_ok=True)
    with open(ROWS_FILE, "a") as f:
        f.write(line + "\n")
    if "phase" in obj:
        name, value = _headline(obj)
        _SUMMARY.append((obj["phase"], time.perf_counter() - _T_START,
                         name, value))


def print_summary() -> None:
    """One line a phase row printed: its name, whether its checks held
    (a failed check's message starts with its phase's name), the
    script's seconds when the row printed and since the row before, and
    its headline figure; then the failed check, if one was."""
    prev = 0.0
    failed = _FAILURES[0] if _FAILURES else ""
    for phase, at, name, value in _SUMMARY:
        head = f" {name}={value:.6g}" if name else ""
        status = "FAILED" if failed.startswith(phase) else "ok"
        print(f"summary: {phase} {status} at={at:.1f}s "
              f"wall={at - prev:.1f}s{head}", flush=True)
        prev = at
    if failed:
        print(f"summary: failed check: {failed[:300]}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        _FAILURES.append(what)
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def synthetic_arima_panel(n_series: int, n_obs: int,
                          seed: int = 0) -> np.ndarray:
    """ARIMA(2,1,2) draws: ARMA(2,2) innovations then one integration
    (the panel of the JAX package's ``bench.py``)."""
    rng = np.random.default_rng(seed)
    phi = np.stack([rng.uniform(0.1, 0.3, n_series),
                    rng.uniform(0.2, 0.5, n_series)], axis=1)
    theta = np.stack([rng.uniform(0.1, 0.4, n_series),
                      rng.uniform(0.0, 0.2, n_series)], axis=1)
    eps = rng.normal(size=(n_series, n_obs + 2)).astype(np.float32)
    y = np.zeros((n_series, n_obs), dtype=np.float32)
    for t in range(n_obs):
        ar = 0.0
        if t >= 1:
            ar = phi[:, 0] * y[:, t - 1]
        if t >= 2:
            ar = ar + phi[:, 1] * y[:, t - 2]
        ma = theta[:, 0] * eps[:, t + 1] + theta[:, 1] * eps[:, t]
        y[:, t] = 1.0 + ar + ma + eps[:, t + 2]
    return np.cumsum(y, axis=1)


def ne_flops_per_step(p: int, q: int, icpt: int, ragged: bool) -> int:
    """Floating-point operations of one lane-step of the ARMA kernel:
    yhat (2 per AR and MA term), e (1), T (2 per MA term per column, plus
    the negation), the ragged weights, sse (2), triu (2 each), Jtr (2
    each)."""
    k = icpt + p + q
    n_tri = k * (k + 1) // 2
    return 2 * (p + q) + 1 + k * (2 * q + 1) + (k + 1 if ragged else 0) \
        + 2 + 2 * n_tri + 2 * k


def ne_bound_s(S: int, n_obs: int, p: int, q: int, icpt: int,
               ragged: bool, packed: bool = False):
    """Least time of one kernel call on the card: bytes it must move
    (y, params, n_valid read once, the output written once: JᵀJ with both
    triangles, Jᵀr and sse, or with ``packed`` the time-major kernel's
    packed triangle) over the HBM rate, and its FLOPs over the fp32 rate;
    the larger wins."""
    k = icpt + p + q
    n_out = 1 + (k * (k + 1) // 2 if packed else k * k) + k
    n_bytes = 4 * S * (n_obs + k + n_out + (1 if ragged else 0))
    flops = ne_flops_per_step(p, q, icpt, ragged) * (n_obs - max(p, q)) * S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, flops


def _ne_errors(got, ref):
    """Normalized errors of ``(JᵀJ, Jᵀr, sse)`` against a reference:
    sse relative to itself, each JᵀJ entry to sqrt(JᵀJ_aa JᵀJ_bb), each
    Jᵀr entry to sqrt(JᵀJ_aa sse) — the Cauchy-Schwarz bounds of the
    entries, so near-zero entries are judged on their lane's scale."""
    import torch

    jtj, jtr, sse = (t.double().cpu() for t in got)
    jtj_r, jtr_r, sse_r = (t.double().cpu() for t in ref)
    diag = torch.diagonal(jtj_r, dim1=-2, dim2=-1)
    return {
        "sse": ((sse - sse_r).abs() / sse_r.abs()).max().item(),
        "jtj": ((jtj - jtj_r).abs() / torch.sqrt(
            diag[:, :, None] * diag[:, None, :])).max().item(),
        "jtr": ((jtr - jtr_r).abs() / torch.sqrt(
            diag * sse_r[:, None])).max().item(),
    }


def ne_cases(panel: np.ndarray, seed: int):
    """The kernel's test cases at the main path's chunk shape: name,
    (p, q, icpt), series, params, n_valid."""
    rng = np.random.default_rng(seed + 1)
    chunk = panel[:CHUNK]
    diffed = np.ascontiguousarray(np.diff(chunk, axis=1))    # n_obs - 1
    S = chunk.shape[0]
    nv = rng.integers(40, diffed.shape[1] + 1, S).astype(np.float32)
    cases = []
    for name, (p, q, icpt), y, ragged in (
            ("arima(2,1,2)+c", (2, 2, 1), diffed, False),
            ("arima(2,1,2)+c ragged", (2, 2, 1), diffed, True),
            ("arima(1,0,0)", (1, 0, 0), chunk, False),
            ("arima(3,0,2)+c", (3, 2, 1), chunk, False),
            ("arima(5,1,5)+c", (5, 5, 1), diffed, False)):
        k = icpt + p + q
        params = (0.1 * rng.normal(size=(S, k))).astype(np.float32)
        cases.append((name, (p, q, icpt), y, params,
                      nv if ragged else None))
    return cases


def phase_kernel_vs_plain(panel, seed, dev):
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    rows, max_abs, tm_max_abs = [], 0.0, 0.0
    for name, (p, q, icpt), y, params, nv in ne_cases(panel, seed):
        y_d = torch.from_numpy(y).to(dev)
        prm_d = torch.from_numpy(params).to(dev)
        nv_d = None if nv is None else torch.from_numpy(nv).to(dev)
        got = arma_ne.normal_equations(prm_d, y_d, p, q, icpt, n_valid=nv_d)
        plain = arma_ne.normal_equations_plain(prm_d, y_d, p, q, icpt,
                                               n_valid=nv_d)
        # the time-major kernel the series-major one replaced (its
        # comparison, never launched on a path), against the same plain
        # pass
        tm = arma_ne.normal_equations_time_major(prm_d, y_d, p, q, icpt,
                                                 n_valid=nv_d)
        ref64 = arma_ne.normal_equations_plain(
            torch.from_numpy(params).double(), torch.from_numpy(y).double(),
            p, q, icpt,
            n_valid=None if nv is None else torch.from_numpy(nv).double())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        vs_plain = _ne_errors(got, plain)
        vs_f64 = _ne_errors(got, ref64)
        tm_vs_plain = _ne_errors(tm, plain)
        if name == "arima(2,1,2)+c":
            max_abs = max((a - b).abs().max().item()
                          for a, b in zip(got, plain))
            tm_max_abs = max((a - b).abs().max().item()
                             for a, b in zip(tm, plain))
        row = {"case": name, "S": y.shape[0], "n_obs": y.shape[1],
               "vs_plain_f32": vs_plain, "vs_plain_f64_cpu": vs_f64,
               "time_major_vs_plain_f32": tm_vs_plain, "tol": NE_TOL}
        rows.append(row)
        for label, errs in (("plain f32", vs_plain), ("plain f64", vs_f64),
                            ("plain f32 (time-major kernel)", tm_vs_plain)):
            for key, err in errs.items():
                check(err <= NE_TOL,
                      f"{name}: kernel vs {label} {key} error {err:.3g} > "
                      f"{NE_TOL:g}")
    return rows, max_abs, tm_max_abs


def phase_main_path(panel, dev, n_refit=N_REFIT, chunk=CHUNK):
    import torch

    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    engine = FitEngine()
    # warm-up: library load, CUDA/cuBLAS handles (not counted)
    engine.stream_fit(panel[:4096], "arima", p=2, d=1, q=2,
                      chunk_size=4096, device=dev)
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    res = engine.stream_fit(panel, "arima", p=2, d=1, q=2,
                            chunk_size=chunk, device=dev, collect=True)
    launches = arma_ne.fit_css_lm.launches
    ne_launches = arma_ne.normal_equations.launches
    iters = res.stats["lm_iterations"]
    check(not res.chunk_failures,
          f"chunk failures: {[f['error'] for f in res.chunk_failures]}")
    check(launches > 0, "the main path never launched the LM-fit kernel")
    check(launches == len(iters) == sum(res.stats["lm_fit_launches"]),
          f"LM-fit kernel launches {launches} != LM chunks {len(iters)}")
    check(ne_launches == 0, f"the ARIMA fit launched the single-pass "
                            f"kernel {ne_launches} times")
    coefs = torch.cat([m.coefficients for m in res.models]).numpy()
    conv = torch.cat([m.diagnostics.converged for m in res.models]).numpy()
    check(coefs.shape == (panel.shape[0], 5), f"coefficients {coefs.shape}")
    check(bool(np.isfinite(coefs[conv]).all()),
          "non-finite coefficients on converged lanes")
    converged_pct = 100.0 * res.n_converged / res.n_series
    check(converged_pct >= 50.0, f"converged_pct {converged_pct:.2f} < 50")

    t0 = time.perf_counter()
    ref = arima.fit(2, 1, 2, panel[:n_refit].astype(np.float64),
                    warn=False, device="cpu")
    refit_s = time.perf_counter() - t0
    both = conv[:n_refit] & ref.diagnostics.converged.numpy()
    dx = np.abs(coefs[:n_refit].astype(np.float64)
                - ref.coefficients.numpy()).max(axis=1)[both]
    agree = {f"{tol:g}": float(np.mean(dx <= tol)) for tol, _ in AGREE}
    for tol, floor in AGREE:
        check(agree[f"{tol:g}"] >= floor,
              f"only {agree[f'{tol:g}']:.3f} of lanes agree with the f64 "
              f"CPU refit to {tol:g} (floor {floor})")
    return {"phase": "main_path", "n_series": res.n_series,
            "n_obs": panel.shape[1], "chunk_size": chunk,
            "n_chunks": res.n_chunks, "wall_s": res.wall_s,
            "chunk_ms": res.wall_s * 1e3 / res.n_chunks,
            "series_per_s": res.rate, "converged_pct": converged_pct,
            "lm_iterations_per_chunk": iters,
            "lm_fit_launches": launches,
            "normal_equations_launches": ne_launches,
            "refit_lanes": n_refit, "refit_cpu_f64_s": refit_s,
            "refit_both_converged": float(np.mean(both)),
            "refit_agree_share": agree,
            "refit_agree_floor": {f"{t:g}": f for t, f in AGREE},
            "refit_median_abs_diff": float(np.median(dx)),
            "chunk_setup": arima_chunk_steps(panel[chunk:2 * chunk], dev)}, \
        launches, res.models[0]


def arima_chunk_steps(part: np.ndarray, dev):
    """CUDA-event times (ms) of the steps of one warm ARIMA(2,1,2) chunk
    fit as ``stream_fit`` runs it: the H2D copy from pinned memory; the
    NaN scan and differencing; the Hannan-Rissanen init; the LM fit (one
    LM-fit kernel launch, the panel's transpose included); quarantine and
    model build; the D2H copy of the model (``collect``).  The steps are
    marked by wrapping the functions ``models.arima`` calls, so the fit
    runs its own code; time between two steps goes to ``other``.  Beside
    them, host-clock times of the engine's host-side staging of a chunk:
    its NaN scan and its copy into a pinned buffer."""
    import torch

    from spark_timeseries_tpu_torch import engine
    from spark_timeseries_tpu_torch.models import arima

    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    def marked(name, fn):
        def call(*args, **kw):
            mark(f"{name}<")
            out = fn(*args, **kw)
            mark(f"{name}>")
            return out
        return call

    names = ("differences_of_order_d", "hannan_rissanen_init", "fit_css_lm")
    saved = {n: getattr(arima, n) for n in names}
    host = torch.empty(part.shape, dtype=torch.float32).pin_memory()
    t0 = time.perf_counter()
    bool(np.isnan(part).any())
    t1 = time.perf_counter()
    host.numpy()[...] = part
    t2 = time.perf_counter()
    statics = engine._statics("arima", dict(p=2, d=1, q=2))
    try:
        for n in names:
            setattr(arima, n, marked(n, saved[n]))
        torch.cuda.synchronize()
        mark("start")
        values = host.to(dev, non_blocking=True)
        mark("h2d")
        model = engine._fit_values("arima", statics, values)
        mark("fit")
        engine._map_tensors(model, lambda t: t.cpu())
        mark("d2h")
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(arima, n, saved[n])

    def ms(a, b):
        return marks[a].elapsed_time(marks[b])

    steps = {"h2d": ms("start", "h2d"),
             "nan_scan_and_differencing": ms("h2d",
                                             "differences_of_order_d>"),
             "hannan_rissanen_init": ms("hannan_rissanen_init<",
                                        "hannan_rissanen_init>"),
             "lm_fit": ms("fit_css_lm<", "fit_css_lm>"),
             "quarantine_and_model": ms("fit_css_lm>", "fit"),
             "d2h": ms("fit", "d2h")}
    total = ms("start", "d2h")
    steps["other"] = total - sum(steps.values())
    steps["total"] = total
    steps["host_nan_scan"] = (t1 - t0) * 1e3
    steps["host_pinned_copy"] = (t2 - t1) * 1e3
    return steps


def _widths(wrapper) -> dict:
    """A one-pass wrapper's histogram of launch widths (lanes, by their
    power-of-two bucket) since it was last cleared."""
    return {str(k): v for k, v in sorted(wrapper.widths.items())}


class ComparisonLaunches:
    """The launches of the time-major one-pass kernels (ARMA and
    Holt-Winters), kept as the series-major kernels' comparison, on the
    paths: each path phase runs
    through :meth:`run`, which sets their counts to 0 just before it and
    reads them just after.  Launches made to compare kernels outside the
    path phases are not counted."""

    def __init__(self, arma_ne, hw_sse):
        self.wrappers = {
            "arma_ne_time_major": arma_ne.normal_equations_time_major,
            "arma_css_time_major": arma_ne.css_cost_time_major,
            "hw_sse_time_major": hw_sse.value_and_grad_time_major}
        self.total = dict.fromkeys(self.wrappers, 0)
        self.by_path = {name: {} for name in self.wrappers}

    def run(self, path: str, phase, *args):
        for wrapper in self.wrappers.values():
            wrapper.launches = 0
        out = phase(*args)
        for name, wrapper in self.wrappers.items():
            self.total[name] += wrapper.launches
            self.by_path[name][path] = wrapper.launches
        return out


def _event_ms(fn, reps: int):
    """Median CUDA-event time of ``fn()`` over ``reps`` calls, after two
    warm-up calls."""
    return float(np.median(_event_times(fn, reps)))


def _event_times(fn, reps: int):
    """CUDA-event times of ``fn()`` over ``reps`` calls, after two warm-up
    calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def first_chunk_init(panel, dev, chunk=CHUNK):
    """The first ARIMA chunk as the LM fit sees it (differenced once, on
    the card) and its Hannan-Rissanen init."""
    import torch

    from spark_timeseries_tpu_torch.models import arima

    y_d = torch.from_numpy(
        np.ascontiguousarray(np.diff(panel[:chunk], axis=1))).to(dev)
    return y_d, arima.hannan_rissanen_init(2, 2, y_d, True)


def phase_timing(panel, seed, dev, lm_chunk):
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    name, (p, q, icpt), y, params, _ = ne_cases(panel, seed)[0]
    y_d = torch.from_numpy(y).to(dev)
    prm_d = torch.from_numpy(params).to(dev)
    S, n_obs = y.shape
    y_t, prm_t = y_d.T.contiguous(), prm_d.T.contiguous()
    kernel_ms = _event_ms(
        lambda: arma_ne._ne_rows(prm_d, y_d, None, None, p, q, icpt), 20)
    time_major_ms = _event_ms(
        lambda: arma_ne._launch(prm_t, y_t, None, p, q, icpt), 20)
    plain_ms = _event_ms(
        lambda: arma_ne._packed_plain(prm_t, y_t, None, p, q, icpt), 3)
    bound_s, bound_by, n_bytes, flops = ne_bound_s(S, n_obs, p, q, icpt,
                                                   False)
    tm_bound_s = ne_bound_s(S, n_obs, p, q, icpt, False, packed=True)[0]
    # the LM-fit kernel on the chunk from its Hannan-Rissanen init
    lm_y, lm_init = lm_chunk
    lm_ms = _event_ms(lambda: arma_ne.fit_css_lm(lm_init, lm_y, p, q, icpt),
                      5)
    return {"phase": "timing", "case": name, "S": S, "n_obs": n_obs,
            "kernel": "arma_ne_rows", "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_us": bound_s * 1e6,
            "bound_by": bound_by, "bytes": n_bytes, "flops": flops,
            "kernel_share_of_bound": bound_s * 1e3 / kernel_ms,
            "tile": arma_ne.rows_tile(S, n_obs, p, q, icpt, False,
                                      dev)._asdict(),
            "time_major_kernel_ms": time_major_ms,
            "time_major_bound_us": tm_bound_s * 1e6,
            "time_major_share_of_bound": tm_bound_s * 1e3 / time_major_ms,
            "lm_fit_ms_a_chunk": lm_ms}


def lm_fit_bound_s(S: int, n_obs: int, p: int, q: int, icpt: int,
                   passes, S_y=None, mask=None):
    """Least time of the LM fit of S dense lanes over an ``S_y``-series
    panel (default ``S``): the pass's flop a lane-step over the fp32 rate,
    and y, x0 (and the mask) read once and x, fun, converged and n_iter
    written once over the HBM rate; the larger wins.  ``passes`` is the
    number of normal-equations passes in all, or with ``mask (S, k)`` each
    lane's ``(S,)``: a masked lane needs only the flop of its own order
    (its set intercept, AR and MA slots), since its masked columns are
    multiplied by 0.  Returns ``(seconds, bound_by, bytes, flops)``."""
    k = icpt + p + q
    n_bytes = 4 * ((S if S_y is None else S_y) * n_obs + S * k
                   * (1 if mask is None else 2)) + S * (4 * k + 4 + 1 + 4)
    steps = n_obs - max(p, q)
    if mask is None:
        flops = ne_flops_per_step(p, q, icpt, False) * steps * passes
    else:
        on = (mask != 0).long()
        lane_flops = ne_flops_per_step(on[:, icpt:icpt + p].sum(1),
                                       on[:, icpt + p:].sum(1),
                                       on[:, :icpt].sum(1), False)
        flops = int((lane_flops * passes.long()).sum()) * steps
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, flops


def _lm_agreement(got, want):
    """Per-lane shares: the same iteration count, ``fun`` within
    ``LM_FUN_RTOL`` relative (NaN matching NaN), the same converged
    flag."""
    import torch

    return {"n_iter_equal": float((got[3] == want[3]).double().mean()),
            "fun_within_1e-5": float(torch.isclose(
                got[1].double(), want[1].double(), rtol=LM_FUN_RTOL,
                atol=0.0, equal_nan=True).double().mean()),
            "converged_equal": float((got[2] == want[2]).double().mean())}


def _max_abs_x(got, want, lanes=None):
    """Largest |x - x_ref| over ``lanes`` (all when None; a NaN on both
    sides counts 0, on one side inf), or None."""
    import torch

    a, b = got[0], want[0]
    dx = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, (a - b).abs())
    dx = torch.nan_to_num(dx, nan=float("inf")).amax(dim=1)
    if lanes is not None:
        dx = dx[lanes]
    return float(dx.max()) if dx.numel() else None


def phase_lm_fit_vs_route(lm_chunk, ne_kernel_ms, dev,
                          plain_lanes=LM_PLAIN_LANES):
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    y_d, init = lm_chunk
    S, n_obs = y_d.shape
    p, q, icpt = 2, 2, 1
    args = (init, y_d, p, q, icpt, 1e-6, 50, None, None)

    # the LM-fit kernel at three block sizes
    sizes = []
    for threads in (64, 128, 256):
        cfg = arma_ne.lm_fit_config(S, n_obs, p, q, icpt, False, dev,
                                    threads)
        ms = _event_ms(lambda: arma_ne._lm_launch(*args, threads=threads), 5)
        sizes.append({**cfg._asdict(), "ms": ms,
                      "occupancy": cfg.blocks_per_sm * threads / 2048})
    lm_ms = next(r["ms"] for r in sizes
                 if r["threads"] == arma_ne.LM_FIT_THREADS)
    got = arma_ne.fit_css_lm(init, y_d, p, q, icpt)

    # the batched LM over the single-pass kernel, one launch per iteration
    arma_ne.normal_equations.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route = arma_ne.fit_css_lm_route(init, y_d, p, q, icpt)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    ne_launches = arma_ne.normal_equations.launches
    iterations = int(route[3].max())
    check(ne_launches == iterations + 1,
          f"arma_ne launches {ne_launches} != the route's iterations + 1")
    per_iter_ms = route_s * 1e3 / max(iterations, 1)
    kernel_per_iter_ms = ne_kernel_ms * ne_launches / max(iterations, 1)
    vs_route = _lm_agreement(got, route)
    same = got[3] == route[3]

    passes = (1 + got[3]).double()
    total = int(passes.sum())
    bound_s, bound_by, n_bytes, flops = lm_fit_bound_s(S, n_obs, p, q, icpt,
                                                       total)
    # the slowest lane alone: one thread, its serial chain
    worst = int(got[3].argmax())
    lane = slice(worst, worst + 1)
    worst_ms = _event_ms(lambda: arma_ne.fit_css_lm(init[lane], y_d[lane],
                                                    p, q, icpt), 5)
    # registers and spills of every instantiation (a lane per thread at
    # the default block size)
    regs = {}
    for pp in range(6):
        for qq in range(6):
            for ic, rg in ((0, False), (0, True), (1, False), (1, True)):
                if pp + qq + ic:
                    cfg = arma_ne.lm_fit_config(S, n_obs, pp, qq, ic, rg,
                                                dev)
                    regs[f"{pp},{qq},{ic}{',ragged' if rg else ''}"] = [
                        cfg.registers, cfg.local_bytes]

    # the plain LM on the card, on the chunk's first lanes
    k = slice(0, plain_lanes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = arma_ne.fit_css_lm_plain(init[k], y_d[k], p, q, icpt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_k = [t[k] for t in got]
    vs_plain = _lm_agreement(got_k, plain)
    route_vs_plain = _lm_agreement([t[k] for t in route], plain)
    row = {"phase": "lm_fit_vs_route", "S": S, "n_obs": n_obs,
           "order": [p, q, icpt], "lm_fit_ms": lm_ms,
           "threads": arma_ne.LM_FIT_THREADS, "block_sizes": sizes,
           "route_ms": route_s * 1e3, "route_arma_ne_launches": ne_launches,
           "route_iterations": iterations,
           "route_iteration_ms": per_iter_ms,
           "route_iteration_kernel_ms": kernel_per_iter_ms,
           "route_iteration_rest_ms": per_iter_ms - kernel_per_iter_ms,
           "speedup": route_s * 1e3 / lm_ms,
           "vs_route": vs_route, "vs_route_floor": LM_ROUTE_SHARE,
           "vs_route_max_abs_x_same_iter": _max_abs_x(got, route, same),
           "vs_route_max_abs_x": _max_abs_x(got, route),
           "lane_passes": {
               "sum": total, "mean": float(passes.mean()),
               "median": float(passes.median()),
               "p99": float(torch.quantile(passes, 0.99)),
               "max": int(passes.max())},
           "converged_pct": 100.0 * float(got[2].double().mean()),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "bytes": n_bytes, "flops": flops,
           "bytes_bound_ms": n_bytes / PEAK_BYTES_S * 1e3,
           "share_of_bound": bound_s * 1e3 / lm_ms,
           "warp_efficiency": _warp_efficiency(1 + got[3]),
           "slowest_lane_alone_ms": worst_ms,
           "slowest_lane_passes": int(passes.max()),
           "slowest_lane_step_ns": worst_ms * 1e6 / (int(passes.max())
                                                     * (n_obs - 2)),
           "registers_and_spill_bytes": regs,
           "registers_max": max(r for r, _ in regs.values()),
           "spill_bytes_max": max(b for _, b in regs.values()),
           "plain_lanes": plain_lanes, "plain_ms": plain_ms,
           "vs_plain": vs_plain, "route_vs_plain": route_vs_plain,
           "vs_plain_margin": LM_PLAIN_MARGIN,
           "vs_plain_max_abs_x_same_iter_converged": _max_abs_x(
               got_k, plain, (got_k[3] == plain[3]) & got_k[2] & plain[2]),
           "vs_plain_max_abs_x_same_iter": _max_abs_x(
               got_k, plain, got_k[3] == plain[3]),
           "vs_plain_max_abs_x": _max_abs_x(got_k, plain)}
    emit(row)     # before the checks, so a failed check leaves its numbers
    for key, floor in zip(("n_iter_equal", "fun_within_1e-5"),
                          LM_ROUTE_SHARE):
        check(vs_route[key] >= floor,
              f"LM-fit kernel vs route: {key} share {vs_route[key]:.4f} "
              f"< {floor}")
        floor = route_vs_plain[key] - LM_PLAIN_MARGIN
        check(vs_plain[key] >= floor,
              f"LM-fit kernel vs plain: {key} share {vs_plain[key]:.4f} "
              f"< the route's {route_vs_plain[key]:.4f} - "
              f"{LM_PLAIN_MARGIN}")
    return row


def synthetic_hw_panel(n_series: int, n_obs: int, period: int,
                       seed: int = 0) -> np.ndarray:
    """``100 + 0.5 t + 10 sin(2πt/period) + N(0, 2²)`` per series (the JAX
    package's ``benchmarks/bench_suite.py`` Holt-Winters recipe), float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_obs, dtype=np.float32)
    base = (100.0 + 0.5 * t
            + 10.0 * np.sin(2 * np.pi * t / period)).astype(np.float32)
    out = rng.standard_normal((n_series, n_obs), dtype=np.float32)
    out *= 2.0
    out += base
    return out


def _hw_refit_part(values: np.ndarray, period: int):
    """One CPU worker's share of the float64 Holt-Winters refit."""
    import torch

    from spark_timeseries_tpu_torch.models import holt_winters

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    m = holt_winters.fit(values, period, "additive", device="cpu")
    return {"x": torch.stack([m.alpha, m.beta, m.gamma], dim=-1).numpy(),
            "fun": m.diagnostics.fun.numpy(),
            "converged": m.diagnostics.converged.numpy(),
            "n_iter": m.diagnostics.n_iter.numpy(),
            "seconds": time.perf_counter() - t0}


def start_hw_refit(hw_panel: np.ndarray):
    """Start the float64 CPU refit of the first ``HW_N_REFIT`` lanes in
    ``HW_REFIT_WORKERS`` spawned processes; returns ``(pool, pending)``."""
    import multiprocessing

    values = hw_panel[:HW_N_REFIT].astype(np.float64)
    pool = multiprocessing.get_context("spawn").Pool(HW_REFIT_WORKERS)
    parts = np.array_split(values, HW_REFIT_WORKERS)
    pending = pool.starmap_async(_hw_refit_part,
                                 [(v, HW_PERIOD) for v in parts])
    return pool, pending


def css_cases(panel: np.ndarray, seed: int):
    """The cost-only kernel's cases at the ARIMA chunk shape: name,
    (p, q, icpt), series, params, n_valid."""
    rng = np.random.default_rng(seed + 2)
    chunk = panel[:CHUNK]
    diffed = np.ascontiguousarray(np.diff(chunk, axis=1))
    S = chunk.shape[0]
    nv = rng.integers(40, diffed.shape[1] + 1, S).astype(np.float32)
    cases = []
    # AR orders in registers (p <= 5), and one past them (runtime p)
    for name, (p, q, icpt), y, ragged in (
            ("arima(2,1,2)+c", (2, 2, 1), diffed, False),
            ("arima(2,1,2)+c ragged", (2, 2, 1), diffed, True),
            ("arima(5,1,0)+c", (5, 0, 1), diffed, False),
            ("arima(4,1,3) ragged", (4, 3, 0), diffed, True),
            ("arima(1,1,5)+c", (1, 5, 1), diffed, False),
            ("arima(8,1,1)+c runtime p", (8, 1, 1), diffed, False)):
        params = (0.1 * rng.normal(size=(S, icpt + p + q))).astype(
            np.float32)
        cases.append((name, (p, q, icpt), y, params,
                      nv if ragged else None))
    return cases


def phase_css_cost_vs_plain(panel, seed, dev):
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    rows, max_abs, tm_max_abs = [], 0.0, 0.0
    for name, (p, q, icpt), y, params, nv in css_cases(panel, seed):
        y_d = torch.from_numpy(y).to(dev)
        prm_d = torch.from_numpy(params).to(dev)
        nv_d = None if nv is None else torch.from_numpy(nv).to(dev)
        got = arma_ne.css_cost(prm_d, y_d, p, q, icpt, n_valid=nv_d)
        plain = arma_ne.css_cost_plain(prm_d, y_d, p, q, icpt, n_valid=nv_d)
        tm = arma_ne.css_cost_time_major(prm_d, y_d, p, q, icpt,
                                         n_valid=nv_d)
        ref64 = arma_ne.css_cost_plain(
            torch.from_numpy(params).double(), torch.from_numpy(y).double(),
            p, q, icpt,
            n_valid=None if nv is None else torch.from_numpy(nv).double())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        errs = {label: ((got.double().cpu() - ref.double().cpu()).abs()
                        / ref.double().cpu().abs()).max().item()
                for label, ref in (("plain f32", plain),
                                   ("plain f64", ref64))}
        errs["plain f32 (time-major kernel)"] = (
            (tm.double().cpu() - plain.double().cpu()).abs()
            / plain.double().cpu().abs()).max().item()
        if name == "arima(2,1,2)+c":
            max_abs = (got - plain).abs().max().item()
            tm_max_abs = (tm - plain).abs().max().item()
        rows.append({"case": name, "S": y.shape[0], "n_obs": y.shape[1],
                     "rel_err": errs, "tol": CSS_TOL})
        for label, err in errs.items():
            check(err <= CSS_TOL, f"{name}: css kernel vs {label} relative "
                                  f"error {err:.3g} > {CSS_TOL:g}")
    return rows, max_abs, tm_max_abs


def _hw_errors(got, ref):
    """Normalized errors of ``(sse, grad)`` against a reference: sse
    relative to itself, each gradient entry relative to the larger of its
    lane's largest reference entry and the lane's SSE (over the unit box
    the SSE moves by about itself, so the SSE is the gradient's natural
    scale where the gradient happens to be small)."""
    import torch

    f, g = (t.double().cpu() for t in got)
    f_r, g_r = (t.double().cpu() for t in ref)
    scale = torch.maximum(g_r.abs().amax(dim=1), f_r.abs())[:, None]
    grad = ((g - g_r).abs() / scale).flatten()
    return {"sse": ((f - f_r).abs() / f_r.abs()).max().item(),
            "grad_q999": torch.quantile(grad, 0.999).item(),
            "grad_max": grad.max().item()}


def hw_cases(hw_panel: np.ndarray, seed: int):
    """The Holt-Winters kernel's cases at the chunk shape: name, period,
    model type, series, params, n_valid."""
    rng = np.random.default_rng(seed + 3)
    chunk = hw_panel[:CHUNK]
    S, n = chunk.shape
    m = HW_PERIOD
    nv = rng.integers(2 * m + 1, n + 1, S)
    ragged = np.where(np.arange(n)[None, :] < nv[:, None], chunk,
                      np.float32(0.0))
    # 52 is not one of the register periods: the generic form
    weekly = synthetic_hw_panel(S, 5 * 52, 52, seed + 4)
    cases = []
    for name, period, model_type, y, lanes_nv in (
            ("additive m=12", m, "additive", chunk, None),
            ("additive m=12 ragged", m, "additive", ragged, nv),
            ("multiplicative m=12", m, "multiplicative", chunk, None),
            ("additive m=52 generic", 52, "additive", weekly, None)):
        params = rng.uniform(0.05, 0.95, size=(S, 3)).astype(np.float32)
        cases.append((name, period, model_type, y, params, lanes_nv))
    return cases


def phase_hw_kernel_vs_plain(hw_panel, seed, dev):
    import torch

    from spark_timeseries_tpu_torch.ops import hw_sse

    rows, max_abs = [], 0.0
    k = HW_F64_LANES
    for name, m, model_type, y, params, nv in hw_cases(hw_panel, seed):
        y_d = torch.from_numpy(y).to(dev)
        prm_d = torch.from_numpy(params).to(dev)
        nv_d = None if nv is None else torch.from_numpy(nv).to(dev)
        got = hw_sse.value_and_grad(prm_d, y_d, m, model_type, n_valid=nv_d)
        old = hw_sse.value_and_grad_time_major(prm_d, y_d, m, model_type,
                                               n_valid=nv_d)
        plain = hw_sse.value_and_grad_plain(prm_d, y_d, m, model_type,
                                            n_valid=nv_d)
        ref64 = hw_sse.value_and_grad_plain(
            torch.from_numpy(params[:k]).double(),
            torch.from_numpy(y[:k]).double(), m, model_type,
            n_valid=None if nv is None else torch.from_numpy(nv[:k]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        vs_plain = _hw_errors(got, plain)
        vs_f64 = _hw_errors([t[:k] for t in got], ref64)
        bitwise = _bits_equal(got, old)
        check(bitwise, f"{name}: hw_sse_rows_kernel differs from the "
                       f"time-major hw_sse_kernel on some lane")
        if name == "additive m=12":
            max_abs = max((a - b).abs().max().item()
                          for a, b in zip(got, plain))
            tm_max_abs = max((a - b).abs().max().item()
                             for a, b in zip(old, plain))
        rows.append({"case": name, "S": y.shape[0], "n_obs": y.shape[1],
                     "period": m, "vs_plain_f32": vs_plain,
                     "vs_plain_f64_cpu": vs_f64, "f64_lanes": k,
                     "bitwise_vs_time_major": bitwise,
                     "tol": HW_TOL, "tol_all": HW_TOL_ALL})
        for label, errs in (("plain f32", vs_plain), ("plain f64", vs_f64)):
            for key, err in errs.items():
                tol = HW_TOL_ALL if key == "grad_max" else HW_TOL
                check(err <= tol, f"{name}: hw kernel vs {label} {key} "
                                  f"error {err:.3g} > {tol:g}")
    return rows, max_abs, tm_max_abs


def phase_hw_path(hw_panel, arima_panel, arima_model, refit, dev,
                  chunk=CHUNK):
    import torch

    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse

    engine = FitEngine()
    kw = dict(period=HW_PERIOD, model_type="additive")
    # warm-up: library load, allocator (not counted)
    engine.stream_fit(hw_panel[:4096], "holt_winters", chunk_size=4096,
                      device=dev, **kw)
    hw_sse.box_fit.launches = 0
    hw_sse.value_and_grad.launches = 0
    arma_ne.css_cost.launches = 0
    res = engine.stream_fit(hw_panel, "holt_winters", chunk_size=chunk,
                            device=dev, collect=True, **kw)
    launches = hw_sse.box_fit.launches
    sse_launches = hw_sse.value_and_grad.launches
    check(not res.chunk_failures,
          f"chunk failures: {[f['error'] for f in res.chunk_failures]}")
    check(launches > 0, "the Holt-Winters path never launched its kernel")
    check(launches == res.n_chunks == sum(res.stats["box_fit_launches"]),
          f"hw_box_fit launches {launches} != chunks {res.n_chunks}")
    check(sse_launches == 0, f"the Holt-Winters fit launched the "
                             f"single-pass kernel {sse_launches} times")
    converged_pct = 100.0 * res.n_converged / res.n_series
    check(converged_pct >= HW_CONVERGED_FLOOR,
          f"Holt-Winters converged_pct {converged_pct:.2f} < "
          f"{HW_CONVERGED_FLOOR}")
    x = torch.cat([torch.stack([m.alpha, m.beta, m.gamma], dim=-1)
                   for m in res.models]).numpy()
    conv = torch.cat([m.diagnostics.converged for m in res.models]).numpy()
    check(x.shape == (hw_panel.shape[0], 3), f"parameters {x.shape}")
    check(bool(np.isfinite(x[conv]).all() and (x[conv] >= 0).all()
               and (x[conv] <= 1).all()),
          "converged lanes' parameters are not finite and in [0, 1]")

    # the cost-only kernel on a path: the CSS log likelihood of the first
    # ARIMA chunk's fitted models, on the card
    model = arima_model._replace(
        coefficients=arima_model.coefficients.to(dev),
        diagnostics=None)
    ll = model.log_likelihood_css(torch.from_numpy(arima_panel[:chunk])
                                  .to(dev)).cpu()
    css_launches = arma_ne.css_cost.launches
    check(css_launches > 0, "log_likelihood_css never launched the css "
                            "kernel")
    # against float64 on the CPU, on converged lanes whose MA part is
    # invertible (elsewhere the error recurrence amplifies float32
    # rounding without bound, in any implementation)
    k = N_REFIT
    ref = model._replace(coefficients=arima_model.coefficients[:k].double())
    ll64 = ref.log_likelihood_css(torch.from_numpy(arima_panel[:k]).double())
    ok = torch.isfinite(ll64) & arima_model.diagnostics.converged[:k] \
        & torch.from_numpy(np.asarray(ref.is_invertible()))
    ll_rel = ((ll[:k].double() - ll64).abs() / ll64.abs())[ok]
    ll_share = float((ll_rel <= LL_TOL).double().mean())
    check(ll_share >= 0.999, f"only {ll_share:.4f} of the card's CSS log "
                             f"likelihoods agree with float64 to {LL_TOL:g}")

    # the float64 CPU refit, by objective
    pool, pending = refit
    t0 = time.perf_counter()
    parts = pending.get(timeout=900)
    waited = time.perf_counter() - t0
    pool.close()
    pool.join()
    ref_x = np.concatenate([p["x"] for p in parts])
    ref_fun = np.concatenate([p["fun"] for p in parts])
    ref_conv = np.concatenate([p["converged"] for p in parts])
    k = HW_N_REFIT
    card_sse = hw_sse.value_and_grad_plain(
        torch.from_numpy(x[:k]).double(),
        torch.from_numpy(hw_panel[:k]).double(), HW_PERIOD,
        "additive")[0].numpy()
    both = conv[:k] & ref_conv
    rel = (card_sse - ref_fun) / ref_fun
    tol, floor = HW_AGREE
    agree = float(np.mean(np.abs(rel[both]) <= tol))
    check(agree >= floor, f"only {agree:.3f} of lanes converged in both "
                          f"have a card SSE within {tol:g} of the float64 "
                          f"fit's (floor {floor})")
    return {"phase": "hw_path", "n_series": res.n_series,
            "n_obs": hw_panel.shape[1], "period": HW_PERIOD,
            "chunk_size": chunk, "n_chunks": res.n_chunks,
            "wall_s": res.wall_s, "series_per_s": res.rate,
            "converged_pct": converged_pct,
            "box_iterations_per_chunk": res.stats["box_iterations"],
            "lane_evaluations_per_chunk": res.stats["lane_evaluations"],
            "hw_box_fit_launches": launches,
            "hw_sse_launches": sse_launches,
            "arima_css_loglik_lanes": int(ll.shape[0]),
            "arima_css_launches": css_launches,
            "arima_css_loglik_f64_lanes": int(ok.sum()),
            "arima_css_loglik_f64_share": ll_share,
            "arima_css_loglik_f64_max_rel": float(ll_rel.max()),
            "refit_lanes": k, "refit_workers": HW_REFIT_WORKERS,
            "refit_cpu_f64_s": max(p["seconds"] for p in parts),
            "refit_waited_s": waited,
            "refit_f64_converged": float(np.mean(ref_conv)),
            "refit_both_converged": float(np.mean(both)),
            "refit_sse_agree_share": agree,
            "refit_sse_agree_tol_floor": [tol, floor],
            "refit_card_not_worse_share": float(
                np.mean(rel[both] <= tol)),
            "refit_median_rel_sse_diff": float(np.median(rel[both]))}, \
        launches, css_launches


# flop a Holt-Winters lane-step (csrc/hw_sse.cu's count): additive,
# multiplicative (its products in e and de, the four quotients and their
# tangents' scalings); a ragged lane's step weights e and de (4 more)
HW_STEP_FLOPS = {True: 81, False: 97}


def hw_bound_s(S: int, n_steps: int, m: int, additive: bool = True,
               ragged: bool = False):
    """Least time of one Holt-Winters kernel call: y, init, params (and
    n_valid) read once and out written once over the HBM rate, the
    lane-steps' flop over the fp32 rate."""
    n_bytes = 4 * S * (n_steps + 2 + m + 3 + 4 + int(ragged))
    flops = (HW_STEP_FLOPS[additive] + 4 * int(ragged)) * n_steps * S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, flops


def css_bound_s(S: int, n_obs: int, p: int, q: int, icpt: int):
    """Least time of one dense cost-only ARMA call: y and params read and
    sse written once; yhat (2 per AR and MA term), e (1) and sse (2) per
    lane-step."""
    n_bytes = 4 * S * (n_obs + icpt + p + q + 1)
    flops = (2 * (p + q) + 3) * (n_obs - max(p, q)) * S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, flops


def _device_ms_each(fns, reps: int):
    """Median device duration of the one kernel each of ``fns`` launches,
    in one fresh ``torch.profiler`` session (``reps`` calls of each in
    turn, after one of each outside it); None for all where the session
    did not receive every launch's device record (PERF.md §6)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if len(evs) != reps * len(fns):
        return [None] * len(fns)
    return [float(np.median([e.time_range.elapsed_us()
                             for e in evs[k * reps:(k + 1) * reps]])) / 1e3
            for k in range(len(fns))]


def _sse_config_row(cfg) -> dict:
    return {**cfg._asdict(), "resident_lanes": cfg.resident_lanes,
            "waves": cfg.waves}


def hw_sse_instantiations(S: int, dev) -> dict:
    """Registers, spill bytes and residency of every instantiation of the
    two one-pass kernels at S lanes: the time-major kernel's periods in
    registers and its generic form (m = 52); the series-major kernel
    reading rows or a time-major copy, its ring in shared memory (m = 12,
    52) or in its global scratch (m = 500)."""
    from spark_timeseries_tpu_torch.ops import hw_sse

    old, new = [], []
    for additive in (True, False):
        for ragged in (False, True):
            for m in (4, 7, 12, 24, 52):
                cfg = hw_sse.sse_config_time_major(S, m, additive, ragged,
                                                   dev)
                old.append({"period": m, "additive": additive,
                            "ragged": ragged, **_sse_config_row(cfg)})
            for rows in (True, False):
                for m in (12, 52, 500):
                    cfg = hw_sse.sse_config(S, m, additive, ragged, rows,
                                            dev)
                    new.append({"period": m, "additive": additive,
                                "ragged": ragged, "rows": rows,
                                **_sse_config_row(cfg)})
    return {"S": S, "time_major": old, "rows": new}


def phase_hw_timing(hw_panel, arima_panel, seed, dev):
    """The one-pass Holt-Winters kernels at the four ``hw_cases``: the
    series-major ``hw_sse_rows_kernel`` on the caller's rows and the
    time-major ``hw_sse_kernel`` it replaced on its copy, CUDA-event
    medians in turns (old, new, new, old) and device medians from one
    fresh profiler session; the ``value_and_grad`` call against the
    time-major call (the panel copied, then the old kernel) in turns, and
    the call's preparation apart (initial components, the copy), and the
    series-major kernel on the time-major copy; each case's bound,
    registers, spills, residency and waves; then the cost-only ARMA
    kernel."""
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse

    reps = HW_TIMING_REPS
    cases, kernels = [], []
    for name, m, model_type, y, params, nv in hw_cases(hw_panel, seed):
        y_d = torch.from_numpy(y).to(dev)
        prm = torch.from_numpy(params).to(dev)
        prm_t = prm.T.contiguous()
        nv_d = None if nv is None else torch.from_numpy(nv).to(dev)
        additive = model_type == "additive"
        inp = hw_sse.prepare(y_d, m, model_type, nv_d, time_major=False)
        inp_tm = hw_sse.prepare(y_d, m, model_type, nv_d)
        S, n = y.shape

        def new_kernel(inp=inp, prm=prm):
            return hw_sse._launch(prm.T, inp)

        def old_kernel(inp_tm=inp_tm, prm_t=prm_t):
            return hw_sse._launch_time_major(prm_t, inp_tm)

        def new_on_copy(inp_tm=inp_tm, prm=prm):
            return hw_sse._launch(prm.T, inp_tm)

        old_ms, new_ms = _in_turns(old_kernel, new_kernel, reps)
        copy_in_ms = _event_ms(new_on_copy, reps)
        old_call, new_call = _in_turns(
            lambda: hw_sse.value_and_grad_time_major(
                prm, y_d, m, model_type, n_valid=nv_d),
            lambda: hw_sse.value_and_grad(prm, y_d, m, model_type,
                                          n_valid=nv_d), reps)
        init_ms = _event_ms(
            lambda: hw_sse.init_components(y_d, m, additive), reps)
        copy_ms = _event_ms(lambda: y_d[:, m:].T.contiguous(), reps)
        bound_s, bound_by, n_bytes, flops = hw_bound_s(
            S, n - m, m, additive, nv is not None)
        cfg = hw_sse.sse_config(S, m, additive, nv is not None, True, dev)
        cfg_tm = hw_sse.sse_config_time_major(S, m, additive,
                                              nv is not None, dev)
        kernels += [old_kernel, new_kernel, new_on_copy]
        cases.append({
            "case": name, "S": S, "n_obs": n, "period": m,
            "kernel_ms": new_ms, "time_major_kernel_ms": old_ms,
            "kernel_on_time_major_copy_ms": copy_in_ms,
            "call_ms": new_call, "time_major_call_ms": old_call,
            "init_components_ms": init_ms, "time_major_copy_ms": copy_ms,
            "bound_us": bound_s * 1e6, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops,
            "share_of_bound": bound_s * 1e3 / new_ms,
            "time_major_share_of_bound": bound_s * 1e3 / old_ms,
            "config": _sse_config_row(cfg),
            "time_major_config": _sse_config_row(cfg_tm)})
    device = _device_ms_each(kernels, 2 * reps)
    for k, case in enumerate(cases):
        old_dev, new_dev, copy_dev = device[3 * k:3 * k + 3]
        case.update(time_major_device_ms=old_dev, device_ms=new_dev,
                    on_time_major_copy_device_ms=copy_dev,
                    device_share_of_bound=None if new_dev is None
                    else case["bound_us"] / 1e3 / new_dev,
                    time_major_device_share_of_bound=None if old_dev is None
                    else case["bound_us"] / 1e3 / old_dev)

    name, m, model_type, y, params, _ = hw_cases(hw_panel, seed)[0]
    y_d = torch.from_numpy(y).to(dev)
    inp = hw_sse.prepare(y_d, m, model_type)
    prm_t = torch.from_numpy(params).to(dev).T.contiguous()
    plain_ms = _event_ms(lambda: hw_sse._packed_plain(prm_t, inp), 3)
    main = cases[0]

    # the cost-only ARMA kernel at the ARIMA chunk shape: the main path's
    # order and the largest AR order in registers, then one past them
    css = []
    for c_name, (p, q, icpt), cy, cparams, nv in css_cases(arima_panel,
                                                         seed):
        if nv is not None or (p, q, icpt) not in CSS_TIMED:
            continue
        cy_d = torch.from_numpy(cy).to(dev)
        cprm_d = torch.from_numpy(cparams).to(dev)
        cy_t, cprm_t = cy_d.T.contiguous(), cprm_d.T.contiguous()
        css_ms = _event_ms(
            lambda: arma_ne._css_rows(cprm_d, cy_d, None, p, q, icpt), 20)
        css_tm_ms = _event_ms(
            lambda: arma_ne._css_launch(cprm_t, cy_t, None, p, q, icpt), 20)
        css_plain_ms = _event_ms(
            lambda: arma_ne._packed_plain(cprm_t, cy_t, None, p, q, icpt,
                                          grad=False), 3)
        c_bound_s, c_bound_by, c_bytes, c_flops = css_bound_s(
            cy.shape[0], cy.shape[1], p, q, icpt)
        css.append({"case": c_name, "S": cy.shape[0], "n_obs": cy.shape[1],
                    "kernel": "arma_css_rows", "kernel_ms": css_ms,
                    "time_major_kernel_ms": css_tm_ms,
                    "plain_ms": css_plain_ms,
                    "bound_us": c_bound_s * 1e6, "bound_by": c_bound_by,
                    "bytes": c_bytes, "flops": c_flops,
                    "share_of_bound": c_bound_s * 1e3 / css_ms})
    return {"phase": "hw_timing", "case": name, "S": main["S"],
            "n_obs": main["n_obs"], "period": m,
            "kernel_ms": main["kernel_ms"],
            "time_major_kernel_ms": main["time_major_kernel_ms"],
            "device_ms": main["device_ms"], "plain_ms": plain_ms,
            "bound_us": main["bound_us"], "bound_by": main["bound_by"],
            "bytes": main["bytes"], "flops": main["flops"],
            "kernel_share_of_bound": main["share_of_bound"],
            "reps": reps, "cases": cases,
            "instantiations": hw_sse_instantiations(main["S"], dev),
            "css": css}


def box_fit_bound_s(S: int, n_steps: int, m: int, evaluations: int):
    """Least time of the box fit of S additive dense lanes that needed
    ``evaluations`` value-and-grad passes in all: 81 flop a lane-step of
    each pass over the fp32 rate, and y, init and x0 read once and x, fun,
    converged, n_iter and the evaluations written once over the HBM
    rate; the larger wins."""
    n_bytes = 4 * S * (n_steps + 2 + m + 3) + S * (4 * 3 + 4 + 1 + 4 + 4)
    flops = 81 * n_steps * evaluations
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, flops


def _warp_efficiency(evals) -> float:
    """Useful passes over the passes a warp runs: each group of 32
    consecutive entries (a warp's threads) runs as long as its longest."""
    w = evals.double().reshape(-1, 32)
    return float(w.sum() / (32.0 * w.amax(dim=1).sum()))


def _box_agreement(got, want, got_evals=None, want_evals=None):
    """Per-lane shares: the same iteration count, ``fun`` within
    ``HW_FUN_RTOL`` relative, the same converged flag (and the same
    evaluations)."""
    same = got.n_iter == want.n_iter
    rel = (got.fun.double() - want.fun.double()).abs() / want.fun.double()
    out = {"n_iter_equal": float(same.double().mean()),
           "fun_within_1e-5": float((rel <= HW_FUN_RTOL).double().mean()),
           "converged_equal": float((got.converged == want.converged)
                                    .double().mean())}
    if got_evals is not None:
        out["evaluations_equal"] = float((got_evals == want_evals)
                                         .double().mean())
    return out


def phase_hw_fit_vs_solver(hw_panel, sse_kernel_ms, dev, chunk=CHUNK,
                           plain_lanes=HW_PLAIN_LANES):
    import torch

    from spark_timeseries_tpu_torch.ops import hw_sse
    from spark_timeseries_tpu_torch.ops.optimize import minimize_box

    m = HW_PERIOD
    y_d = torch.from_numpy(hw_panel[:chunk]).to(dev)
    inp = hw_sse.prepare(y_d, m, "additive")
    n_steps, S = inp.y.shape
    x0 = torch.tensor([0.3, 0.1, 0.1], device=dev).expand(S, 3)
    kw = dict(tol=1e-10, max_iter=1000, max_backtracks=40)

    def launch(sub=inp, start=x0, **extra):
        return hw_sse._box_launch(sub, start, 0.0, 1.0, **kw, **extra)

    # the box-fit kernel at three block sizes
    sizes = []
    for threads in (64, 128, 256):
        cfg = hw_sse.box_fit_config(inp, threads)
        ms = _event_ms(lambda: launch(threads=threads), 3)
        sizes.append({**cfg._asdict(), "ms": ms,
                      "occupancy": cfg.blocks_per_sm * threads / 2048})
    chosen = hw_sse.box_fit_config(inp).threads
    box_ms = next(r["ms"] for r in sizes if r["threads"] == chosen)
    got, evals, per_thread = launch(thread_evals=True)

    # the batched solver over the single-pass kernel, one launch per trial
    hw_sse.value_and_grad.launches = 0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route = minimize_box(hw_sse.evaluator(inp), x0, 0.0, 1.0, stats=stats,
                         **kw)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    sse_launches = hw_sse.value_and_grad.launches
    check(sse_launches == stats["calls"] > 0,
          f"hw_sse launches {sse_launches} != the solver's calls "
          f"{stats['calls']}")
    iterations = max(stats["iterations"], 1)
    per_iter_ms = route_s * 1e3 / iterations
    kernel_per_iter_ms = sse_kernel_ms * sse_launches / iterations

    vs_solver = _box_agreement(got, route, evals, stats["evaluations"])
    e = evals.double()
    total = int(evals.sum())
    bound_s, bound_by, n_bytes, flops = box_fit_bound_s(S, n_steps, m, total)

    # the slowest lane alone: one thread, its serial chain
    worst = int(evals.argmax())
    lane = slice(worst, worst + 1)
    alone = hw_sse.HWInputs(inp.y[:, lane].contiguous(),
                            inp.init[:, lane].contiguous(), None, m, True)
    worst_ms = _event_ms(lambda: launch(alone, x0[lane]), 3)

    # the plain box fit on the card, on the chunk's first lanes
    k = plain_lanes
    head = hw_sse.HWInputs(inp.y[:, :k].contiguous(),
                           inp.init[:, :k].contiguous(), None, m, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, plain_evals = hw_sse.box_fit_plain(head, x0[:k], **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_k = hw_sse.MinimizeResult(*(t[:k] for t in got[:4]))
    vs_plain = _box_agreement(got_k, plain, evals[:k], plain_evals)
    route_vs_plain = _box_agreement(
        hw_sse.MinimizeResult(*(t[:k] for t in route[:4])), plain,
        stats["evaluations"][:k], plain_evals)
    same = got_k.n_iter == plain.n_iter
    dx = (got_k.x - plain.x).abs().amax(dim=1)
    row = {"phase": "hw_fit_vs_solver", "S": S, "n_obs": y_d.shape[1],
            "period": m, "box_fit_ms": box_ms, "threads": chosen,
            "block_sizes": sizes,
            "solver_route_ms": route_s * 1e3,
            "solver_route_hw_sse_launches": sse_launches,
            "solver_route_iterations": stats["iterations"],
            "solver_route_trials_per_iteration":
                stats["trials"] / iterations,
            "solver_route_iteration_ms": per_iter_ms,
            "solver_route_iteration_kernel_ms": kernel_per_iter_ms,
            "solver_route_iteration_rest_ms":
                per_iter_ms - kernel_per_iter_ms,
            "speedup": route_s * 1e3 / box_ms,
            "vs_solver": vs_solver, "vs_solver_floor": HW_SOLVER_SHARE,
            "lane_evaluations": {
                "sum": total, "mean": float(e.mean()),
                "median": float(e.median()),
                "p99": float(torch.quantile(e, 0.99)),
                "max": int(evals.max())},
            "lane_iterations_max": int(got.n_iter.max()),
            "converged_pct": 100.0 * float(got.converged.double().mean()),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops,
            "share_of_bound": bound_s * 1e3 / box_ms,
            "warp_efficiency_queue": _warp_efficiency(per_thread),
            "warp_efficiency_lane_per_thread": _warp_efficiency(evals),
            "slowest_lane_alone_ms": worst_ms,
            "slowest_lane_step_ns": worst_ms * 1e6 / (int(evals.max())
                                                      * n_steps),
            "plain_lanes": k, "plain_ms": plain_ms, "vs_plain": vs_plain,
            "solver_route_vs_plain": route_vs_plain,
            "vs_plain_margin": HW_PLAIN_MARGIN,
            "vs_plain_max_abs_x_same_iter": float(dx[same].max())
            if bool(same.any()) else None,
            "vs_plain_max_abs_x": float(dx.max())}
    emit(row)     # before the checks, so a failed check leaves its numbers
    for key, floor in zip(("n_iter_equal", "fun_within_1e-5"),
                          HW_SOLVER_SHARE):
        check(vs_solver[key] >= floor,
              f"box-fit kernel vs solver: {key} share {vs_solver[key]:.4f} "
              f"< {floor}")
        floor = route_vs_plain[key] - HW_PLAIN_MARGIN
        check(vs_plain[key] >= floor,
              f"box-fit kernel vs plain: {key} share {vs_plain[key]:.4f} "
              f"< the solver route's {route_vs_plain[key]:.4f} - "
              f"{HW_PLAIN_MARGIN}")
    return row


def _auto_ref_part(values: np.ndarray):
    """The float64 CPU run of ``auto_fit_panel`` the card's orders are
    held against (in a spawned process)."""
    import torch

    from spark_timeseries_tpu_torch.models import arima

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    fit = arima.auto_fit_panel(values, device="cpu", **AUTO_GRID)
    return {"orders": fit.orders, "coefficients": fit.coefficients,
            "aic": fit.aic, "seconds": time.perf_counter() - t0}


def start_auto_ref(auto_panel: np.ndarray):
    """Start the float64 CPU auto-fit of the first ``AUTO_N_REF`` series
    in a spawned process; returns ``(pool, pending)``."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    pending = pool.apply_async(
        _auto_ref_part, (auto_panel[:AUTO_N_REF].astype(np.float64),))
    return pool, pending


def phase_auto_fit_path(auto_panel, auto_ref, dev):
    """The batched auto-ARIMA on the card, its stages timed apart by
    wrapping the functions ``models.arima`` calls (the KPSS tests, the
    two LM stages); the first LM call's inputs (the screen's) are kept
    for ``auto_grid_vs_route``."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    # warm-up: the grid's kernels, allocator, cuBLAS (not counted)
    arima.auto_fit_panel(auto_panel[:4096], device=dev, **AUTO_GRID)
    marks, screen_args = [], []
    real_kpss, real_lm = arima.kpsstest, arima.fit_css_lm

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def kpss(*args, **kw):
        mark("kpss<")
        out = real_kpss(*args, **kw)
        mark("kpss>")
        return out

    def lm(*args, **kw):
        if not screen_args:
            screen_args.append((args, kw))
        mark("lm<")
        out = real_lm(*args, **kw)
        mark("lm>")
        return out

    stats = {}
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    arima.kpsstest, arima.fit_css_lm = kpss, lm
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        fit = arima.auto_fit_panel(auto_panel, device=dev, stats=stats,
                                   **AUTO_GRID)
        mark("end")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        arima.kpsstest, arima.fit_css_lm = real_kpss, real_lm
    launches = arma_ne.fit_css_lm.launches
    ne_launches = arma_ne.normal_equations.launches
    C = (AUTO_GRID["max_p"] + 1) * (AUTO_GRID["max_q"] + 1)
    k = 1 + AUTO_GRID["max_p"] + AUTO_GRID["max_q"]
    check(launches == C + 1 == stats["lm_fit_launches"],
          f"auto_fit_panel launched the LM-fit kernel {launches} times "
          f"(stats: {stats['lm_fit_launches']}), not C + 1 = {C + 1} (a "
          f"screen launch per candidate, the refine)")
    check(ne_launches == 0, f"auto_fit_panel launched the single-pass "
                            f"kernel {ne_launches} times")
    x0, y = screen_args[0][0][:2]
    check(tuple(x0.shape) == (C * auto_panel.shape[0], k)
          and tuple(y.shape) == auto_panel.shape,
          f"the screen ran x0 {tuple(x0.shape)} over y {tuple(y.shape)}")

    ev = dict((n, e) for n, e in marks if n in ("start", "end"))
    kp = [e for n, e in marks if n.startswith("kpss")]
    lm_ev = [e for n, e in marks if n.startswith("lm")]
    steps = {"kpss": kp[0].elapsed_time(kp[-1]),
             "hr_init": kp[-1].elapsed_time(lm_ev[0]),
             "screen": lm_ev[0].elapsed_time(lm_ev[1]),
             "refine": lm_ev[2].elapsed_time(lm_ev[3]),
             "total": ev["start"].elapsed_time(ev["end"])}
    steps["other"] = steps["total"] - sum(
        steps[k] for k in ("kpss", "hr_init", "screen", "refine"))

    orders = fit.orders
    check(orders.shape == (auto_panel.shape[0], 3)
          and fit.coefficients.shape == (auto_panel.shape[0], k),
          f"orders {orders.shape}, coefficients {fit.coefficients.shape}")
    finite = np.isfinite(fit.aic)
    check(bool(np.isfinite(fit.coefficients[finite]).all()),
          "non-finite coefficients on series with a finite AIC")
    check(float(np.mean(finite)) >= 0.99,
          f"only {np.mean(finite):.4f} of series got an admissible model")
    hist = {}
    for (p, _, q), c in zip(*np.unique(orders, axis=0, return_counts=True)):
        hist[f"{p},{q}"] = hist.get(f"{p},{q}", 0) + int(c)
    d_share = {str(d): float(np.mean(orders[:, 1] == d))
               for d in range(AUTO_GRID["max_d"] + 1)}

    # the float64 CPU run of the first series
    pool, pending = auto_ref
    t0 = time.perf_counter()
    ref = pending.get(timeout=900)
    waited = time.perf_counter() - t0
    pool.close()
    pool.join()
    k = AUTO_N_REF
    same = np.all(orders[:k] == ref["orders"], axis=1)
    dcoef = np.abs(fit.coefficients[:k] - ref["coefficients"]).max(axis=1)
    share = float(np.mean(same))
    median = float(np.median(dcoef[same])) if same.any() else float("inf")
    row = {"phase": "auto_fit_path", "n_series": auto_panel.shape[0],
           "n_obs": auto_panel.shape[1], "seed": AUTO_SEED,
           "grid": AUTO_GRID, "candidates": C, "wall_s": wall,
           "series_per_s": auto_panel.shape[0] / wall,
           "arma_lm_fit_launches": launches,
           "arma_ne_launches": ne_launches, "steps_ms": steps,
           "orders_pq_histogram": hist, "d_share": d_share,
           "screen_capped_share": stats["screen_capped"],
           "admissible_share": float(np.mean(finite)),
           "ref_series": k, "ref_cpu_f64_s": ref["seconds"],
           "ref_waited_s": waited,
           "ref_orders_equal_share": share,
           "ref_orders_floor": AUTO_ORDERS_FLOOR,
           "ref_d_equal_share": float(np.mean(orders[:k, 1]
                                              == ref["orders"][:, 1])),
           "ref_median_max_abs_coef_diff": median,
           "ref_p90_max_abs_coef_diff": float(np.quantile(dcoef[same], 0.9))
           if same.any() else None,
           "ref_coef_median_limit": AUTO_COEF_MEDIAN}
    emit(row)     # before the checks, so a failed check leaves its numbers
    check(share >= AUTO_ORDERS_FLOOR,
          f"only {share:.3f} of {k} series chose the float64 CPU run's "
          f"orders (floor {AUTO_ORDERS_FLOOR})")
    check(median < AUTO_COEF_MEDIAN,
          f"median max |Δcoef| {median:.3g} against the float64 CPU run "
          f">= {AUTO_COEF_MEDIAN:g}")
    return row, launches, screen_args[0]


def _by_value(a, b):
    """Per-lane equality of ``a`` and ``b`` (NaN matching NaN)."""
    import torch

    eq = a == b
    if a.is_floating_point():
        eq |= torch.isnan(a) & torch.isnan(b)
    return eq if eq.dim() == 1 else eq.all(dim=1)


def _trace_x_differs(lanes, x0, y, p, q, icpt, tol, max_iter, mask, nv,
                     orders):
    """Each of ``lanes``, whose x differs between the per-candidate screen
    and the padded launch, fitted alone both ways with ``max_iter``
    stepped up until the two part: the first iteration where they do,
    which side took its trial step there, and the padded normal equations
    from the single-pass kernel (the LM-fit kernel's own pass) at the
    point before and at the trial point.  The padded launch post-scales
    an unowned slot's entries by 0, so an entry that overflowed becomes
    inf * 0 = NaN: at the point before, the NaN enters the Cholesky
    factor and the back substitution spreads it over every slot of the
    step, so the trial is NaN; at the trial point, its test ``ok``
    fails.  Either way the padded launch refuses a trial that the
    candidate's own order, which never forms those entries, judges on
    its owned terms."""
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    S_y = y.shape[0]
    out = []
    for lane in lanes:
        c, s = divmod(int(lane), S_y)
        own = arma_ne._order_mask([orders[c]], 1, 1, p, q, icpt, y.dtype,
                                  y.device)
        xl, m_own = x0[lane:lane + 1], mask[lane:lane + 1] * own
        yl = y[s:s + 1]
        nvl = None if nv is None else nv[s:s + 1]

        def fits(n):
            kw = dict(tol=tol, max_iter=n, n_valid=nvl)
            return (arma_ne.fit_css_lm(xl, yl, p, q, icpt, mask=m_own,
                                       grid_orders=[orders[c]], **kw),
                    arma_ne.fit_css_lm(xl, yl, p, q, icpt, mask=m_own, **kw))

        prev, row = fits(0), None
        for n in range(1, max_iter + 1):
            cur = fits(n)
            if not bool(_by_value(cur[0][0], cur[1][0])):
                took = [not bool(_by_value(a[0], b[0]))
                        for a, b in zip(cur, prev)]
                row = {"lane": int(lane), "order": list(orders[c]),
                       "first_differing_iter": n,
                       "per_candidate_took": took[0], "padded_took": took[1],
                       "state_before_equal": all(
                           bool(_by_value(a, b).all())
                           for a, b in zip(prev[0], prev[1])),
                       "fun_before": float(prev[0][1][0]),
                       "fun_trial": float(cur[0 if took[0] else 1][1][0])}
                o = m_own[0] > 0
                points = (("before", prev[0][0]),
                          ("trial", cur[0 if took[0] else 1][0]))
                for name, xp in points:
                    jtj, jtr, sse = arma_ne.normal_equations(
                        xp * m_own, yl, p, q, icpt, n_valid=nvl)
                    owned = torch.cat([jtj[0][o][:, o].reshape(-1),
                                       jtr[0][o], sse])
                    unowned = torch.cat([jtj[0][~o].reshape(-1),
                                         jtr[0][~o]])
                    row[f"owned_finite_{name}"] = bool(
                        torch.isfinite(owned).all())
                    row[f"owned_max_abs_{name}"] = float(owned.abs().max())
                    row[f"unowned_nonfinite_{name}"] = int(
                        (~torch.isfinite(unowned)).sum())
                    row[f"unowned_max_abs_{name}"] = float(
                        unowned.abs().max())
                row["explained"] = (
                    took[0] and not took[1] and row["state_before_equal"]
                    and row["owned_finite_before"]
                    and row["owned_finite_trial"]
                    and row["unowned_nonfinite_before"]
                    + row["unowned_nonfinite_trial"] > 0)
                break
            prev = cur
        out.append(row or {"lane": int(lane), "explained": False,
                           "first_differing_iter": None})
    return out


def phase_auto_grid_vs_route(screen, dev):
    """The LM-fit kernel in grid mode at the screen's inputs: one launch
    per candidate at its own order (the screen as ``auto_fit_panel`` runs
    it) and the padded single launch, timed in turns at full size and held
    against each other; each candidate's launch timed alone, with its
    residency and bound; the per-candidate screen against the route and
    the plain LM on the lanes of the panel's first series."""
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    (x0, y, p, q, icpt), kw = screen[0][:5], screen[1]
    mask, nv, orders = kw["mask"], kw["n_valid"], kw["grid_orders"]
    tol, iters = kw["tol"], kw["max_iter"]
    S_y, n_obs = y.shape
    S, k = x0.shape
    C = S // S_y
    check(orders is not None and len(orders) == C,
          f"the screen passed grid_orders {orders} for {C} candidates")
    ragged = nv is not None

    def run(x, m, yy, grid=True):
        return arma_ne.fit_css_lm(x, yy, p, q, icpt, tol=tol,
                                  max_iter=iters, mask=m, n_valid=nv,
                                  grid_orders=orders if grid else None)

    # padded, per candidate, per candidate, padded
    turns = [_event_ms(lambda: run(x0, mask, y, grid), 3)
             for grid in (False, True, True, False)]
    padded_ms, ms = float(np.mean(turns[::3])), float(np.mean(turns[1:3]))
    got = run(x0, mask, y)
    padded = run(x0, mask, y, grid=False)
    vs_padded = _lm_agreement(got, padded)
    # equal by value on every output (NaN matching NaN; a zero's sign may
    # differ in the slots a candidate does not own)
    same = [_by_value(a, b) for a, b in zip(got, padded)]
    by_value = same[0] & same[1] & same[2] & same[3]
    finite = torch.isfinite(padded[0]).all(dim=1) & torch.isfinite(padded[1])
    # a lane that diverges: the padded form's masked slots make
    # 0 * inf = NaN where the candidate's own order keeps inf
    inf_vs_nan = torch.isinf(got[1]) & torch.isnan(padded[1])
    x_differs = ~same[0]
    other = ~by_value & ~x_differs & ~(inf_vs_nan & same[2] & same[3])
    traced = _trace_x_differs(
        torch.nonzero(x_differs).flatten()[:GRID_TRACE_LANES].tolist(), x0,
        y, p, q, icpt, tol, iters, mask, nv, orders)

    passes = (1 + got[3]).double()
    total = int(passes.sum())
    bound_s, bound_by, n_bytes, flops = lm_fit_bound_s(
        S, n_obs, p, q, icpt, passes, S_y=S_y, mask=mask)
    # every lane charged the padded order's step, as the padded launch
    # runs it
    padded_s, _, _, padded_flops = lm_fit_bound_s(
        S, n_obs, p, q, icpt, int((1 + padded[3]).sum()), S_y=S_y)
    padded_s = max(padded_s, n_bytes / PEAK_BYTES_S)

    # each candidate's launch alone, at its own order, as a grid of one
    candidates = []
    for c, (pc, qc) in enumerate(orders):
        blk = slice(c * S_y, (c + 1) * S_y)
        c_ms = _event_ms(lambda: arma_ne.fit_css_lm(
            x0[blk], y, p, q, icpt, tol=tol, max_iter=iters, mask=mask[blk],
            n_valid=nv, grid_orders=[(pc, qc)]), 3)
        cfg = arma_ne.lm_fit_config(S_y, n_obs, pc, qc, icpt, ragged, dev)
        c_s, _, _, c_flops = lm_fit_bound_s(S_y, n_obs, p, q, icpt,
                                            passes[blk], mask=mask[blk])
        candidates.append({
            "order": [pc, qc], "ms": c_ms, "bound_ms": c_s * 1e3,
            "flops": c_flops, "lane_passes_mean": float(passes[blk].mean()),
            "lane_passes_max": int(passes[blk].max()),
            "blocks_per_sm": cfg.blocks_per_sm, "registers": cfg.registers,
            "local_bytes": cfg.local_bytes})
    worst = int(got[3].argmax())
    wl, ws = slice(worst, worst + 1), worst % S_y
    worst_ms = _event_ms(lambda: arma_ne.fit_css_lm(
        x0[wl], y[ws:ws + 1], p, q, icpt, tol=tol, max_iter=iters,
        mask=mask[wl], n_valid=None if nv is None else nv[ws:ws + 1],
        grid_orders=[orders[worst // S_y]]), 3)

    def lanes_of(n_series):
        return (torch.arange(C, device=dev)[:, None] * S_y
                + torch.arange(n_series, device=dev)).reshape(-1)

    # the route, on the C lanes of each of the first AUTO_ROUTE_SERIES
    r_lanes = lanes_of(AUTO_ROUTE_SERIES)
    r_y = y[:AUTO_ROUTE_SERIES]
    r_nv = None if nv is None else nv[:AUTO_ROUTE_SERIES]
    r_got = arma_ne.fit_css_lm(x0[r_lanes], r_y, p, q, icpt, tol=tol,
                               max_iter=iters, mask=mask[r_lanes],
                               n_valid=r_nv, grid_orders=orders)
    arma_ne.normal_equations.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route = arma_ne.fit_css_lm_route(x0[r_lanes], r_y, p, q, icpt, tol=tol,
                                     max_iter=iters, mask=mask[r_lanes],
                                     n_valid=r_nv, grid_orders=orders)
    torch.cuda.synchronize()
    route_ms = (time.perf_counter() - t0) * 1e3
    route_launches = arma_ne.normal_equations.launches
    vs_route = _lm_agreement(r_got, route)
    full_vs_sliced = all(torch.equal(torch.nan_to_num(a[r_lanes]),
                                     torch.nan_to_num(b))
                         for a, b in zip(got, r_got))

    # the plain LM, float32 on the card, on the first AUTO_PLAIN_SERIES
    pl = lanes_of(AUTO_PLAIN_SERIES)
    p_idx = torch.searchsorted(r_lanes, pl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = arma_ne.fit_css_lm_plain(
        x0[pl], y[:AUTO_PLAIN_SERIES], p, q, icpt, tol=tol, max_iter=iters,
        mask=mask[pl],
        n_valid=None if nv is None else nv[:AUTO_PLAIN_SERIES],
        grid_orders=orders)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_pl = [t[p_idx] for t in r_got]
    vs_plain = _lm_agreement(got_pl, plain)
    route_vs_plain = _lm_agreement([t[p_idx] for t in route], plain)
    row = {"phase": "auto_grid_vs_route", "order": [p, q, icpt],
           "lanes": S, "series": S_y, "candidates": C, "n_obs": n_obs,
           "max_iter": iters, "tol": tol, "kernel_ms": ms,
           "padded_launch_ms": padded_ms, "turns_ms": {
               "padded": turns[::3], "per_candidate": turns[1:3]},
           "side_streams": arma_ne.LM_GRID_STREAMS,
           "candidates_alone_ms_sum": sum(c["ms"] for c in candidates),
           "per_candidate": candidates,
           "padded_config": arma_ne.lm_fit_config(
               S, n_obs, p, q, icpt, ragged, dev)._asdict(),
           "lane_passes": {
               "sum": total, "mean": float(passes.mean()),
               "median": float(passes.median()),
               "max": int(passes.max())},
           "converged_share": float(got[2].double().mean()),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "bytes": n_bytes, "flops": flops,
           "bytes_bound_ms": n_bytes / PEAK_BYTES_S * 1e3,
           "share_of_bound": bound_s * 1e3 / ms,
           "padded_share_of_bound": bound_s * 1e3 / padded_ms,
           "padded_bound_ms": padded_s * 1e3, "padded_flops": padded_flops,
           "vs_padded": vs_padded, "vs_padded_floor": LM_ROUTE_SHARE,
           "vs_padded_max_abs_x": _max_abs_x(got, padded),
           "vs_padded_equal_by_value": float(by_value.double().mean()),
           "vs_padded_equal_by_value_finite": float(
               by_value[finite].double().mean()) if finite.any() else None,
           "padded_finite_share": float(finite.double().mean()),
           "vs_padded_fun_inf_vs_nan_share": float(
               inf_vs_nan.double().mean()),
           "vs_padded_inf_vs_nan_lanes": int(inf_vs_nan.sum()),
           "vs_padded_inf_vs_nan_x_equal_lanes": int(
               (inf_vs_nan & same[0]).sum()),
           "vs_padded_x_differs_share": float(x_differs.double().mean()),
           "vs_padded_x_differs_lanes": int(x_differs.sum()),
           "vs_padded_x_differs_traced": traced,
           "vs_padded_other_differs_lanes": int(other.sum()),
           "warp_efficiency": _warp_efficiency(
               torch.nn.functional.pad(1 + got[3], (0, (-S) % 32))),
           "slowest_lane_alone_ms": worst_ms,
           "slowest_lane_passes": int(passes.max()),
           "route_series": AUTO_ROUTE_SERIES, "route_lanes": len(r_lanes),
           "route_ms": route_ms, "route_arma_ne_launches": route_launches,
           "full_grid_equals_sliced_grid": full_vs_sliced,
           "vs_route": vs_route, "vs_route_floor": LM_ROUTE_SHARE,
           "vs_route_max_abs_x": _max_abs_x(r_got, route),
           "plain_series": AUTO_PLAIN_SERIES, "plain_lanes": len(pl),
           "plain_ms": plain_ms, "vs_plain": vs_plain,
           "route_vs_plain": route_vs_plain,
           "vs_plain_margin": LM_PLAIN_MARGIN,
           "vs_plain_max_abs_x_same_iter_converged": _max_abs_x(
               got_pl, plain, (got_pl[3] == plain[3]) & got_pl[2]
               & plain[2])}
    emit(row)     # before the checks, so a failed check leaves its numbers
    check(full_vs_sliced, "the grid's lanes fitted with the whole panel "
                          "differ from the same lanes over its first "
                          "series")
    # every lane where the per-candidate screen and the padded launch part
    # is one of the two kinds the masked slots' arithmetic explains
    check(int(other.sum()) == 0,
          f"per-candidate screen vs the padded launch: {int(other.sum())} "
          f"lanes differ otherwise than by an inf fun against NaN or a "
          f"trial refused for an overflow in an unowned slot")
    check(len(traced) == int(x_differs.sum())
          and all(t["explained"] for t in traced),
          f"per-candidate screen vs the padded launch: of "
          f"{int(x_differs.sum())} lanes whose x differs, "
          f"{sum(t['explained'] for t in traced)} traced to a trial the "
          f"padded launch refused for an overflow in an unowned slot")
    for key, floor in zip(("n_iter_equal", "fun_within_1e-5"),
                          LM_ROUTE_SHARE):
        check(vs_padded[key] >= floor,
              f"per-candidate screen vs the padded launch: {key} share "
              f"{vs_padded[key]:.4f} < {floor}")
        check(vs_route[key] >= floor,
              f"grid LM-fit kernel vs route: {key} share "
              f"{vs_route[key]:.4f} < {floor}")
        floor = route_vs_plain[key] - LM_PLAIN_MARGIN
        check(vs_plain[key] >= floor,
              f"grid LM-fit kernel vs plain: {key} share "
              f"{vs_plain[key]:.4f} < the route's {route_vs_plain[key]:.4f}"
              f" - {LM_PLAIN_MARGIN}")
    return row


def gappy_panel(panel: np.ndarray, seed: int) -> np.ndarray:
    """A copy of ``panel`` with the Panel phase's gaps, drawn from
    ``seed``: ``PANEL_LATE_SHARE`` of the series start 1 to
    ``PANEL_LATE_MAX`` steps late (leading NaN), and ``PANEL_GAP_SHARE``
    of the observations strictly inside each window are knocked out."""
    rng = np.random.default_rng([seed, 7])
    S, n = panel.shape
    start = np.where(rng.random(S) < PANEL_LATE_SHARE,
                     rng.integers(1, PANEL_LATE_MAX + 1, S), 0)
    out = panel.copy()
    t = np.arange(n)[None, :]
    out[t < start[:, None]] = np.nan
    gaps = rng.random((S, n), dtype=np.float32) < PANEL_GAP_SHARE
    gaps &= (t > start[:, None]) & (t < n - 1)
    out[gaps] = np.nan
    return out


def _bitwise_equal(a, b) -> bool:
    """Equal bit for bit (a NaN equals a NaN of the same bits)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and bool(np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def ragged_lm_vs_route(part: np.ndarray, coefs: np.ndarray, dev,
                       plain_lanes=LM_PLAIN_LANES):
    """The LM-fit kernel's ragged form at the Panel path's shapes: the
    first chunk of the filled panel staged as ``arima.fit`` stages it for
    the LM fit (``ragged_view``, one difference, the Hannan-Rissanen init
    over each lane's window), fitted by the kernel, whose x quarantined
    as the fit does must be ``coefs``, the coefficients the path
    collected; then held, as in ``lm_fit_vs_route``, against the batched
    LM over the single-pass kernel on every lane and on the ragged lanes
    alone, and against the plain LM on ragged and dense lanes."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne
    from spark_timeseries_tpu_torch.ops.ragged import ragged_view

    p, q, icpt, tol, max_iter = 2, 2, 1, 1e-6, arima.LM_MAX_ITER
    ts, obs_len = ragged_view(torch.from_numpy(part).to(dev))
    check(obs_len is not None, "the Panel path's first chunk is not ragged")
    y = arima.differences_of_order_d(ts, 1)[..., 1:]
    y = y.reshape(-1, y.shape[-1])
    nv = torch.clamp(obs_len - 1, min=0).reshape(-1)
    min_n = 2 * max(p, q) + 2 + p + q + icpt
    check(int((nv < min_n).sum()) == 0,
          "a lane of the Panel path's first chunk is too short to fit")
    init = arima.hannan_rissanen_init(p, q, y, True, n_valid=nv)
    got = arma_ne.fit_css_lm(init, y, p, q, icpt, tol, max_iter, n_valid=nv)
    staged = torch.where(torch.isfinite(got[0]).all(dim=-1, keepdim=True),
                         got[0], init).cpu().numpy()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route = arma_ne.fit_css_lm_route(init, y, p, q, icpt, tol, max_iter,
                                     n_valid=nv)
    torch.cuda.synchronize()
    route_ms = (time.perf_counter() - t0) * 1e3
    ragged = nv < y.shape[1]
    rag = torch.nonzero(ragged).squeeze(1)
    lanes = torch.cat([rag[:plain_lanes // 2],
                       torch.nonzero(~ragged).squeeze(1)[:plain_lanes // 2]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = arma_ne.fit_css_lm_plain(init[lanes], y[lanes], p, q, icpt, tol,
                                     max_iter, n_valid=nv[lanes])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_k = [t[lanes] for t in got]
    row = {"lanes": y.shape[0], "ragged_lanes": int(rag.numel()),
           "collected_coefficients_bitwise": _bitwise_equal(staged, coefs),
           "route_ms": route_ms, "vs_route": _lm_agreement(got, route),
           "vs_route_ragged": _lm_agreement([t[rag] for t in got],
                                            [t[rag] for t in route]),
           "vs_route_floor": LM_ROUTE_SHARE,
           "vs_route_max_abs_x_ragged": _max_abs_x(got, route, rag),
           "plain_lanes": {"ragged": int(min(rag.numel(), plain_lanes // 2)),
                           "all": int(lanes.numel())},
           "plain_ms": plain_ms, "vs_plain": _lm_agreement(got_k, plain),
           "route_vs_plain": _lm_agreement([t[lanes] for t in route],
                                           plain),
           "vs_plain_margin": LM_PLAIN_MARGIN}
    return row


def check_ragged_lm(row) -> None:
    check(row["collected_coefficients_bitwise"],
          "the LM-fit kernel on the staged first chunk differs from the "
          "coefficients Panel.stream_fit collected")
    for key, floor in zip(("n_iter_equal", "fun_within_1e-5"),
                          LM_ROUTE_SHARE):
        for what in ("vs_route", "vs_route_ragged"):
            check(row[what][key] >= floor,
                  f"ragged LM-fit kernel {what}: {key} share "
                  f"{row[what][key]:.4f} < {floor}")
        floor = row["route_vs_plain"][key] - LM_PLAIN_MARGIN
        check(row["vs_plain"][key] >= floor,
              f"ragged LM-fit kernel vs plain: {key} share "
              f"{row['vs_plain'][key]:.4f} < the route's "
              f"{row['route_vs_plain'][key]:.4f} - {LM_PLAIN_MARGIN}")


def phase_panel_path(panel, auto_panel, seed, dev):
    """The Panel tier on the card: the CSV round trip, a gappy Panel of
    the main path's panel, its fill, ``Panel.stream_fit`` and
    ``Panel.auto_fit``, each kernel run's launches counted over exactly
    that run."""
    import tempfile

    import torch

    from spark_timeseries_tpu_torch import Panel, io
    from spark_timeseries_tpu_torch import time as ttime
    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne
    from spark_timeseries_tpu_torch.ops import univariate as uv
    from spark_timeseries_tpu_torch.utils import metrics

    S, n = panel.shape
    index = ttime.uniform("2000-01-03T00:00Z", n,
                          ttime.BusinessDayFrequency(1))
    keys = [f"series-{i}" for i in range(S)]
    row = {"phase": "panel_path", "n_series": S, "n_obs": n,
           "index": index.to_string()}

    # 1. the CSV round trip of one chunk's worth of series
    csv_panel = Panel(index, panel[:PANEL_CSV_SERIES],
                      keys[:PANEL_CSV_SERIES], device=dev)
    metrics.reset()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        io.save_csv(csv_panel, tmp)
        save_s = time.perf_counter() - t0
        csv_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                        for f in os.listdir(tmp))
        t0 = time.perf_counter()
        back = io.load_csv(tmp, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    counters = metrics.snapshot()["counters"]
    # float32 on the card; the float64 read is exact on either device
    csv_exact = _bitwise_equal(
        back.values.cpu().numpy().astype(np.float64),
        panel[:PANEL_CSV_SERIES].astype(np.float64))
    row["csv"] = {"n_series": PANEL_CSV_SERIES, "bytes": csv_bytes,
                  "save_s": save_s, "load_s": load_s,
                  "native_calls": counters.get("io.csv_codec_native", 0),
                  "python_calls": counters.get("io.csv_codec_python", 0),
                  "bit_exact": csv_exact,
                  "keys_equal": back.keys == csv_panel.keys,
                  "index_equal": back.index.to_string()
                  == index.to_string()}
    del csv_panel, back

    # 2. the gappy 1M-series panel onto the card
    gappy = gappy_panel(panel, seed)
    late = np.isnan(gappy[:, 0])
    torch.cuda.synchronize()
    metrics.reset()
    t0 = time.perf_counter()
    big = Panel(index, gappy, keys, device=dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    h2d_bytes = metrics.snapshot()["counters"].get("panel.h2d_bytes", 0)
    row["panel"] = {"late_share": float(late.mean()),
                    "gap_share": float(np.isnan(gappy).mean()),
                    "h2d_s": h2d_s, "h2d_bytes": h2d_bytes,
                    "h2d_gb_s": h2d_bytes / h2d_s / 1e9}

    # 3. fill("linear") on the card against the CPU's float32 fill; its
    # two neighbour scans timed alone
    fill_ms = _event_ms(lambda: big.fill("linear"), 5)
    valid = ~torch.isnan(big.values)
    iota = uv._iota(big.values)
    scans_ms = {"prev_valid_cummax": _event_ms(
        lambda: uv._prev_valid_idx(valid, iota), 3),
        "next_valid_cummin": _event_ms(
        lambda: uv._next_valid_idx(valid, iota), 3)}
    del valid, iota
    filled = big.fill("linear")
    del big
    k = PANEL_FILL_CPU_ROWS
    t0 = time.perf_counter()
    cpu_fill = uv.fill_linear(torch.from_numpy(gappy[:k])).numpy()
    cpu_fill_s = time.perf_counter() - t0
    card_fill = filled.values[:k].cpu().numpy()
    same_nan = bool(np.array_equal(np.isnan(card_fill), np.isnan(cpu_fill)))
    ok = ~np.isnan(cpu_fill)
    diff = np.abs(card_fill[ok].astype(np.float64) - cpu_fill[ok])
    rel = diff / np.maximum(np.abs(cpu_fill[ok]).astype(np.float64), 1e-30)
    row["fill"] = {"ms": fill_ms, "scans_ms": scans_ms,
                   # each element read once and written once
                   "gb_s": 2 * gappy.nbytes / (fill_ms * 1e-3) / 1e9,
                   "cpu_rows": k, "cpu_s": cpu_fill_s,
                   "bitwise_equal": _bitwise_equal(card_fill, cpu_fill),
                   "nan_masks_equal": same_nan,
                   "elements_differing": int(np.sum(diff > 0)),
                   "max_abs_diff": float(diff.max()),
                   "max_rel_diff": float(rel.max()),
                   "rel_bound": FILL_RTOL}
    valid = ~np.isnan(gappy[:k])
    inside = (np.cumsum(valid, axis=1) > 0) \
        & (np.cumsum(valid[:, ::-1], axis=1)[:, ::-1] > 0)
    row["fill"]["interior_nan_left"] = int(np.sum(np.isnan(card_fill)
                                                  & inside))
    del gappy

    # 4. Panel.stream_fit against the engine on the same values from the
    # host; the launches counted over exactly the panel's run
    engine = FitEngine()
    kw = dict(p=2, d=1, q=2, chunk_size=CHUNK, collect=True)
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    res = filled.stream_fit("arima", engine=engine, **kw)
    launches = arma_ne.fit_css_lm.launches
    ne_launches = arma_ne.normal_equations.launches
    host = filled.values.cpu().numpy()
    ref = engine.stream_fit(host, "arima", device=dev, **kw)
    # one chunk's steps (its host gap scan, then on the card), ragged
    # lanes and all
    from spark_timeseries_tpu_torch import engine as engine_mod
    t0 = time.perf_counter()
    engine_mod._interior_gap_count(host[:CHUNK])
    gap_count_ms = (time.perf_counter() - t0) * 1e3
    chunk_steps = arima_chunk_steps(host[:CHUNK], dev)
    chunk_steps["host_interior_gap_count"] = gap_count_ms
    coefs = res.models[0].coefficients.numpy()
    converged_pct = 100.0 * res.n_converged / res.n_series
    d2h = res.stats["input_d2h_s"]
    row["stream_fit"] = {
        "n_chunks": res.n_chunks, "wall_s": res.wall_s,
        "series_per_s": res.rate, "input_d2h_s": d2h,
        "input_d2h_gb_s": host.nbytes / d2h / 1e9,
        "series_per_s_with_d2h": res.n_fitted / (res.wall_s + d2h),
        "converged_pct": converged_pct,
        "ragged_share": float(np.isnan(host[:, 0]).mean()),
        "lm_iterations_per_chunk": res.stats["lm_iterations"],
        "engine_wall_s": ref.wall_s, "engine_series_per_s": ref.rate,
        "first_chunk_steps_ms": chunk_steps,
        "n_converged": res.n_converged,
        "engine_n_converged": ref.n_converged,
        "first_chunk_coefficients_bitwise": _bitwise_equal(
            coefs, ref.models[0].coefficients.numpy())}
    row["arma_lm_fit_launches"] = launches
    row["arma_ne_launches"] = ne_launches
    del filled, ref, res
    # the ragged LM fit of the first chunk against the route and the
    # plain LM (comparison launches, after the counts were read)
    row["ragged_lm"] = ragged_lm_vs_route(host[:CHUNK], coefs, dev)
    del host

    # 5. Panel.auto_fit against auto_fit_panel on the same values
    auto = Panel(index.islice(0, auto_panel.shape[1]), auto_panel,
                 keys[:auto_panel.shape[0]], device=dev)
    stats = {}
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = auto.auto_fit(stats=stats, **AUTO_GRID)
    auto_s = time.perf_counter() - t0
    auto_launches = arma_ne.fit_css_lm.launches
    auto_ne = arma_ne.normal_equations.launches
    want = arima.auto_fit_panel(auto_panel, device=dev, **AUTO_GRID)
    C = (AUTO_GRID["max_p"] + 1) * (AUTO_GRID["max_q"] + 1)
    row["auto_fit"] = {
        "n_series": auto.n_series, "wall_s": auto_s,
        "series_per_s": auto.n_series / auto_s,
        "orders_bitwise": _bitwise_equal(fit.orders, want.orders),
        "coefficients_bitwise": _bitwise_equal(fit.coefficients,
                                               want.coefficients)}
    row["auto_fit_launches"] = auto_launches
    row["auto_fit_arma_ne_launches"] = auto_ne
    row["arma_ne_launches"] += auto_ne
    emit(row)     # before the checks, so a failed check leaves its numbers

    csv = row["csv"]
    check(csv["native_calls"] == 2 and csv["python_calls"] == 0,
          f"the CSV round trip ran the native codec {csv['native_calls']} "
          f"and the Python path {csv['python_calls']} times, not native "
          f"twice")
    check(csv["bit_exact"] and csv["keys_equal"] and csv["index_equal"],
          "the CSV round trip changed the values, keys or index")
    fill = row["fill"]
    check(fill["nan_masks_equal"] and fill["interior_nan_left"] == 0,
          "the card's fill left NaN where the CPU's did not, or inside a "
          "window")
    check(fill["max_rel_diff"] <= FILL_RTOL,
          f"the card's fill differs from the CPU's by "
          f"{fill['max_rel_diff']:.3g} relative (bound {FILL_RTOL:.3g})")
    sf = row["stream_fit"]
    chunks = -(-S // CHUNK)
    check(launches == sf["n_chunks"] == len(sf["lm_iterations_per_chunk"])
          == chunks,
          f"Panel.stream_fit launched the LM-fit kernel {launches} times "
          f"for {sf['n_chunks']} chunks ({chunks} expected)")
    check(ne_launches == 0, f"Panel.stream_fit launched the single-pass "
                            f"kernel {ne_launches} times")
    check(sf["converged_pct"] >= 50.0,
          f"Panel.stream_fit converged_pct {sf['converged_pct']:.2f} < 50")
    check(sf["n_converged"] == sf["engine_n_converged"]
          and sf["first_chunk_coefficients_bitwise"],
          "Panel.stream_fit differs from FitEngine().stream_fit of the same "
          "values")
    check_ragged_lm(row["ragged_lm"])
    check(auto_launches == C + 1 == stats["lm_fit_launches"]
          and auto_ne == 0,
          f"Panel.auto_fit launched the LM-fit kernel {auto_launches} times "
          f"(stats: {stats['lm_fit_launches']}) and the single pass "
          f"{auto_ne} times, not C + 1 = {C + 1} and 0")
    check(row["auto_fit"]["orders_bitwise"]
          and row["auto_fit"]["coefficients_bitwise"],
          "Panel.auto_fit differs from auto_fit_panel of the same values")
    return row


def resilient_panel(panel: np.ndarray, seed: int):
    """A copy of ``panel`` with the resilient phase's pathological rows,
    drawn from ``seed`` (disjoint sets): ``RES_SHARE`` of the series each
    all-NaN, constant, with one inf, with one interior gap and too short,
    and ``RES_LATE_SHARE`` healthy late starts.  Returns the panel and the
    rows of each kind."""
    rng = np.random.default_rng([seed, 11])
    S, n = panel.shape
    k = int(S * RES_SHARE)
    order = rng.permutation(S)
    kinds = ["all_nan", "constant", "has_inf", "interior_gap", "too_short"]
    rows = {kind: np.sort(order[i * k:(i + 1) * k])
            for i, kind in enumerate(kinds)}
    rows["late"] = np.sort(order[5 * k:5 * k + int(S * RES_LATE_SHARE)])
    out = panel.copy()
    out[rows["all_nan"]] = np.nan
    out[rows["constant"]] = out[rows["constant"], :1]
    out[rows["has_inf"], rng.integers(0, n, k)] = np.inf
    out[rows["interior_gap"], rng.integers(1, n - 1, k)] = np.nan
    out[rows["too_short"], :n - RES_SHORT_WINDOW] = np.nan
    lead = rng.integers(1, RES_LATE_MAX + 1, rows["late"].size)
    late = out[rows["late"]]
    late[np.arange(n)[None, :] < lead[:, None]] = np.nan
    out[rows["late"]] = late
    return out, rows


def _model_bitwise(a, b) -> bool:
    """Two fitted models' tensor fields (diagnostics included) equal bit
    for bit."""
    import torch

    def leaves(m):
        out = []
        for v in m:
            if isinstance(v, torch.Tensor):
                out.append(v.detach().cpu().numpy())
            elif isinstance(v, tuple):
                out.extend(leaves(v))
        return out

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(_bitwise_equal(x, y)
                                      for x, y in zip(la, lb))


def restart_route_check(part: np.ndarray, lanes: np.ndarray, dev):
    """The restart loop over the LM-fit kernel against the same loop
    over ``fit_css_lm_route`` (one ``arma_ne`` launch per iteration), on
    the given rows of a chunk staged as ``arima.fit`` stages them, with
    the same draws."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne, optimize
    from spark_timeseries_tpu_torch.ops.ragged import ragged_view
    from spark_timeseries_tpu_torch.ops.univariate import \
        differences_of_order_d
    from spark_timeseries_tpu_torch.utils.resilience import RetryPolicy

    ts, obs = ragged_view(torch.from_numpy(part[lanes]).to(dev))
    diffed = differences_of_order_d(ts, 1)[..., 1:]
    nv = None if obs is None else torch.clamp(obs - 1, min=0)
    init = arima.hannan_rissanen_init(2, 2, diffed, True, n_valid=nv)
    pol = RetryPolicy()
    draws = optimize.restart_draws(pol.max_restarts, init.shape[0], 5,
                                   init.dtype, dev, pol.seed)

    def restarted(fit):
        def solve(xs, idx):
            y = diffed if idx is None else diffed.index_select(0, idx)
            v = None if nv is None else (nv if idx is None
                                         else nv.index_select(0, idx))
            return fit(xs, y, 2, 2, 1, tol=1e-6, max_iter=arima.LM_MAX_ITER,
                       n_valid=v)
        res = optimize.solve_with_restarts(
            solve, init, pol.max_restarts, pol.perturb_scale,
            jitter_draws=draws)
        torch.cuda.synchronize()
        return res

    kern = restarted(arma_ne.fit_css_lm)
    ne0 = arma_ne.normal_equations.launches
    route = restarted(arma_ne.fit_css_lm_route)
    agree = _lm_agreement(tuple(kern[:4]), tuple(route[:4]))
    agree["attempts_equal"] = float((kern.attempts == route.attempts)
                                    .double().mean())
    agree["lanes"] = int(lanes.size)
    agree["route_arma_ne_launches"] = arma_ne.normal_equations.launches - ne0
    agree["max_abs_x_same_iter"] = _max_abs_x(
        tuple(kern[:4]), tuple(route[:4]), kern.n_iter == route.n_iter)
    return agree


def resilient_chunk_steps(part_dev, out, dev):
    """Host-clock ms (each step synchronised) of the resilient chain's
    steps on one chunk, replayed one by one: the health classification
    and its D2H, the primary fit with its restarts, the common-factor
    screen on the host, the auto-order stage over the lanes it is offered
    and the AR and mean stages over the lanes left to them."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.utils import resilience as res_mod

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        return val, (time.perf_counter() - t0) * 1e3

    n = part_dev.shape[1]
    health, ms_health = timed(lambda: res_mod.classify_series(
        part_dev, min_len=12).cpu().numpy())
    skipped = res_mod.unfittable_mask(health)
    place = torch.as_tensor(res_mod._placeholder_rows(n, np.float32),
                            device=dev)
    safe = torch.where(torch.as_tensor(skipped, device=dev)[:, None],
                       place[None], part_dev)
    primary, ms_primary = timed(lambda: arima.fit(
        2, 1, 2, safe, retry=res_mod.RetryPolicy(), warn=False, device=dev))
    suspect, ms_suspect = timed(lambda: arima._cancellation_suspects(primary))

    def stage_rows(idx):
        return torch.as_tensor(idx, device=dev)

    conv = primary.diagnostics.converged.cpu().numpy()
    offered = np.flatnonzero((~conv | suspect) & ~skipped)
    stage = arima._make_auto_order_stage(2, 1, 2, None)
    _, ms_auto = timed(lambda: stage(safe.index_select(0,
                                                       stage_rows(offered))))
    later = np.flatnonzero(np.isin(out.fallback_used, (2, 3))
                           | (out.status == res_mod.STATUS_ABANDONED))
    _, ms_ar = timed(lambda: arima.fit(2, 1, 0, safe.index_select(
        0, stage_rows(later)), warn=False, device=dev))
    _, ms_mean = timed(lambda: arima.fit(0, 1, 0, safe.index_select(
        0, stage_rows(later)), warn=False, device=dev))
    return {"classify": ms_health, "primary_with_restarts": ms_primary,
            "cancellation_suspects_host": ms_suspect,
            "auto_order_stage": ms_auto, "auto_order_lanes": int(offered.size),
            "ar_stage": ms_ar, "mean_stage": ms_mean,
            "later_stage_lanes": int(later.size)}


def phase_resilient_path(panel, seed, dev, chunk=CHUNK):
    """The fail-soft ARIMA(2,1,2) fit of the north-star panel with
    pathological rows: ``FitEngine().stream_fit(resilient=True,
    retry=RetryPolicy(), auto_order=True)`` in 131072-series chunks, its
    kernel launches counted over exactly that run, then its first chunk
    against the direct chain, ``Panel.fit_resilient``, the plain fit, the
    CPU classification, and the restart loop over the route."""
    import torch

    from spark_timeseries_tpu_torch import Panel
    from spark_timeseries_tpu_torch import time as ttime
    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne
    from spark_timeseries_tpu_torch.utils import resilience as res_mod

    rp, rows = resilient_panel(panel, seed)
    S, n = rp.shape
    kw = dict(p=2, d=1, q=2, resilient=True, retry=res_mod.RetryPolicy(),
              auto_order=True)
    engine = FitEngine()
    # warm-up on a slice with every pathology (not counted)
    warm = np.concatenate([rp[:4096]] + [rp[r[:8]] for r in rows.values()])
    engine.stream_fit(warm, "arima", chunk_size=warm.shape[0], device=dev,
                      **kw)
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    arma_ne.css_cost.launches = 0
    res = engine.stream_fit(rp, "arima", chunk_size=chunk, device=dev,
                            collect=True, **kw)
    launches = arma_ne.fit_css_lm.launches
    ne_launches = arma_ne.normal_equations.launches
    css_launches = arma_ne.css_cost.launches
    st = res.stats
    statuses = st["resilient_statuses"]
    usable = sum(statuses.get(k, 0) for k in ("ok", "retried", "fallback"))
    row = {"phase": "resilient_path", "n_series": S, "n_obs": n,
           "chunk_size": chunk, "n_chunks": res.n_chunks,
           "pathological_rows": {k: int(v.size) for k, v in rows.items()},
           "wall_s": res.wall_s, "series_per_s": res.rate,
           "statuses": statuses, "usable_pct": 100.0 * usable / S,
           "attempts_histogram": st["resilient_attempts"],
           "lm_fit_launches_per_chunk": st["lm_fit_launches"],
           "lm_fit_launches_by_stage_per_chunk":
               st["lm_fit_launches_by_stage"],
           "restart_lanes_per_chunk": st["restart_lanes"],
           "arma_lm_fit_launches": launches,
           "arma_ne_launches": ne_launches, "arma_css_launches": css_launches}

    # the first chunk against the direct chain, the Panel and the plain fit
    part = rp[:chunk]
    part_dev = torch.from_numpy(part).to(dev)
    stats = {}
    arma_ne.fit_css_lm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct, out = arima.fit_resilient(part_dev, 2, 1, 2, auto_order=True,
                                      device=dev, stats=stats)
    torch.cuda.synchronize()
    row["chunk_fit_resilient_s"] = time.perf_counter() - t0
    row["chunk_lm_fit_launches_by_stage"] = stats["lm_fit_launches_by_stage"]
    row["chunk_launches_match_stats"] = \
        arma_ne.fit_css_lm.launches == stats["lm_fit_launches"]
    row["chunk0_bitwise_direct"] = _model_bitwise(res.models[0], direct)
    index = ttime.uniform("2000-01-03T00:00Z", n,
                          ttime.BusinessDayFrequency(1))
    tp = Panel(index, part_dev, [f"s{i}" for i in range(chunk)], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_model, p_out = tp.fit_resilient("arima", 2, 1, 2, auto_order=True)
    torch.cuda.synchronize()
    row["panel_fit_resilient_s"] = time.perf_counter() - t0
    row["panel_bitwise_direct"] = _model_bitwise(p_model, direct) \
        and bool(np.array_equal(p_out.status, out.status))
    skipped = res_mod.unfittable_mask(out.health)
    safe = part.copy()
    safe[skipped] = res_mod._placeholder_rows(n, part.dtype)
    plain = arima.fit(2, 1, 2, torch.from_numpy(safe).to(dev), warn=False,
                      device=dev)
    ok = out.status == res_mod.STATUS_OK
    row["ok_lanes"] = int(ok.sum())
    row["ok_bitwise_plain"] = _bitwise_equal(
        direct.coefficients.cpu().numpy()[ok],
        plain.coefficients.cpu().numpy()[ok])
    # informational: the healthy rows fitted alone (another batch size)
    healthy = np.flatnonzero(~skipped)
    alone = arima.fit(2, 1, 2, torch.from_numpy(part[healthy]).to(dev),
                      warn=False, device=dev)
    same = (alone.coefficients.cpu().numpy()
            == plain.coefficients.cpu().numpy()[healthy]).all(axis=1)
    row["healthy_rows_alone_bitwise_share"] = float(same.mean())
    # fit_resilient's min_len at (2,1,2) with intercept: d + the
    # Hannan-Rissanen floor 2·max(p, q) + 2 + p + q + 1
    cpu_health = res_mod.classify_series(torch.from_numpy(part),
                                         min_len=1 + 11).numpy()
    row["health_bitwise_cpu"] = _bitwise_equal(out.health, cpu_health)
    row["health_counts"] = {res_mod.HEALTH_NAMES[c]: int((out.health == c)
                                                         .sum())
                            for c in np.unique(out.health)}
    row["skipped_nan_and_zero_attempts"] = bool(
        np.isnan(out.params[skipped]).all()
        and (out.attempts[skipped] == 0).all())
    row["chunk_steps_ms"] = resilient_chunk_steps(part_dev, out, dev)
    retried = np.flatnonzero(out.attempts > 1)
    retried = retried[~skipped[retried]][:RES_ROUTE_LANES]
    row["restart_vs_route"] = restart_route_check(part, retried, dev)
    emit(row)     # before the checks, so a failed check leaves its numbers

    check(not res.chunk_failures,
          f"chunk failures: {[f['error'] for f in res.chunk_failures]}")
    check(launches > 0 and launches == sum(st["lm_fit_launches"]),
          f"the resilient path launched the LM-fit kernel {launches} times, "
          f"its stages counted {sum(st['lm_fit_launches'])}")
    check(ne_launches == 0, f"the resilient path launched the single-pass "
                            f"kernel {ne_launches} times")
    check(row["chunk_launches_match_stats"],
          "the direct chain's LM-fit launches differ from its stats")
    check(statuses.get("skipped", 0) == sum(
        rows[k].size for k in ("all_nan", "has_inf", "interior_gap",
                               "too_short")),
          f"skipped {statuses.get('skipped', 0)} lanes, not the "
          f"pathological rows")
    check(row["chunk0_bitwise_direct"],
          "stream_fit(resilient=True)'s first chunk differs from "
          "arima.fit_resilient of the same rows")
    check(row["panel_bitwise_direct"],
          "Panel.fit_resilient differs from arima.fit_resilient")
    check(row["ok_lanes"] > 0 and row["ok_bitwise_plain"],
          "OK lanes differ from the plain arima.fit")
    check(row["health_bitwise_cpu"] and row["skipped_nan_and_zero_attempts"],
          "health codes differ from the CPU classification, or skipped "
          "lanes carry parameters or attempts")
    rv = row["restart_vs_route"]
    check(rv["lanes"] > 0 and rv["n_iter_equal"] >= LM_ROUTE_SHARE[0]
          and rv["fun_within_1e-5"] >= LM_ROUTE_SHARE[1],
          f"the restart loop over the kernel agrees with the loop over "
          f"the route on n_iter {rv['n_iter_equal']:.4f} / fun "
          f"{rv['fun_within_1e-5']:.4f} of {rv['lanes']} lanes (floors "
          f"{LM_ROUTE_SHARE})")
    return row


def _share_close(got, want, sane, rtol, atol=0.0) -> float:
    """Share of ``sane`` lanes whose every entry of ``got`` (the card's,
    float32) lies within ``rtol`` of ``want`` (the CPU's float64),
    relative to the lane's largest ``|want|`` (plus ``atol``)."""
    g = got.detach().double().cpu().numpy().reshape(len(sane), -1)[sane]
    w = want.detach().double().cpu().numpy().reshape(len(sane), -1)[sane]
    scale = np.abs(w).max(axis=1, keepdims=True) + atol
    with np.errstate(invalid="ignore"):
        ok = (np.abs(g - w) <= rtol * scale).all(axis=1)
    return float(ok.mean()) if ok.size else 0.0


def phase_arima_surface(panel, seed, dev, chunk=CHUNK):
    """The fitted model's methods and the residual tests on one
    131072-lane chunk and its fit on the card, each timed with CUDA
    events and its kernel launches counted, each held against the port's
    float64 CPU run on the first ``SURF_CPU_LANES`` lanes of the same
    coefficients.  The gradient is taken away from the fit, at its
    coefficients plus a jitter from ``seed``: at the optimum it is ~0 by
    construction, where a kernel that returned zeros would pass."""
    import torch

    from spark_timeseries_tpu_torch import stats as tstats
    from spark_timeseries_tpu_torch.models import arima, base, convert
    from spark_timeseries_tpu_torch.ops import arma_ne

    y = torch.from_numpy(panel[:chunk]).to(dev)
    model = arima.fit(2, 1, 2, y, warn=False, device=dev)
    L = SURF_CPU_LANES
    y64 = torch.from_numpy(panel[:L].astype(np.float64))
    m64 = convert.arima_from_numpy(
        2, 1, 2, model.coefficients[:L].cpu().double().numpy(),
        device="cpu")
    sane = m64.is_stationary() & m64.is_invertible()
    jitter = torch.from_numpy(np.random.default_rng(seed).normal(
        0.0, SURF_GRAD_JITTER, model.coefficients.shape).astype(np.float32))
    mj = convert.arima_from_numpy(
        2, 1, 2, (model.coefficients + jitter.to(dev)).cpu().numpy(),
        device=dev)
    mj64 = convert.arima_from_numpy(
        2, 1, 2, mj.coefficients[:L].cpu().double().numpy(), device="cpu")
    sane_j = mj64.is_stationary() & mj64.is_invertible()
    d = y[:, 1:] - y[:, :-1]
    d64 = y64[:, 1:] - y64[:, :-1]
    trend = torch.linspace(0.0, 1.0, panel.shape[1] - 1, device=dev)
    factors = trend[None, :, None].expand(chunk, -1, 1)

    def residual_tests(m, r, X):
        return (tstats.lbtest(r, 10)[0], tstats.dwtest(r),
                tstats.bgtest(r, X, 2)[0])

    def refit(v, m):
        return arima.fit(2, 1, 2, v, max_iter=200, warn=False,
                         device=v.device, user_init_params=m.coefficients)

    cases = [
        ("forecast_interval",
         lambda m, yy, dd, X: torch.stack(m.forecast_interval(yy, 12)[1:]),
         5),
        ("approx_aic", lambda m, yy, dd, X: m.approx_aic(yy), 20),
        ("gradient_log_likelihood_css_arma",
         lambda m, yy, dd, X: m.gradient_log_likelihood_css_arma(dd), 20),
        ("coefficient_precision",
         lambda m, yy, dd, X: m.coefficient_precision(yy), 2),
        ("remove_time_dependent_effects",
         lambda m, yy, dd, X: m.remove_time_dependent_effects(yy), 5),
        ("residual_tests",
         lambda m, yy, dd, X: torch.stack(residual_tests(
             m, m.remove_time_dependent_effects(yy)[:, 1:], X)), 5),
        ("adftest", lambda m, yy, dd, X: tstats.adftest(yy, 2, "c")[0], 5),
        ("kpsstest_ct", lambda m, yy, dd, X: tstats.kpsstest(yy, "ct")[0],
         5),
    ]
    row = {"phase": "arima_surface", "lanes": chunk, "cpu_lanes": L,
           "sane_cpu_lanes": int(sane.sum()), "rtol": SURF_RTOL,
           "share_floor": SURF_SHARE, "methods": {}}
    counters = (arma_ne.fit_css_lm, arma_ne.normal_equations,
                arma_ne.css_cost)
    totals = {"arma_lm_fit": 0, "arma_ne": 0, "arma_css": 0}
    # the widths of the counted one-pass launches, by power-of-two bucket
    widths = {"arma_ne": {}, "arma_css": {}}

    def counted(fn):
        for c in counters:
            c.launches = 0
            if c is not arma_ne.fit_css_lm:
                c.widths.clear()
        out = fn()
        torch.cuda.synchronize()
        got = dict(zip(totals, (c.launches for c in counters)))
        for k2, v in got.items():
            totals[k2] += v
        for key, c in (("arma_ne", arma_ne.normal_equations),
                       ("arma_css", arma_ne.css_cost)):
            for b, n in _widths(c).items():
                widths[key][b] = widths[key].get(b, 0) + n
        return out, got

    grad = "gradient_log_likelihood_css_arma"
    for name, fn, reps in cases:
        m, m_64, ok = (mj, mj64, sane_j) if name == grad \
            else (model, m64, sane)
        out, got = counted(lambda: fn(m, y, d, factors))
        ms = _event_ms(lambda: fn(m, y, d, factors), reps)
        ref = fn(m_64, y64, d64, factors[:L].cpu().double())
        out_l = out[:, :L] if name in ("forecast_interval",
                                       "residual_tests") else out[:L]
        ref_l = ref
        if name in ("forecast_interval", "residual_tests"):
            out_l, ref_l = out_l.transpose(0, 1), ref.transpose(0, 1)
        # the ADF t statistic sits near 0 on many lanes: its tolerance is
        # relative to the lane's largest |t| + 1
        share = _share_close(out_l, ref_l, ok, SURF_RTOL,
                             atol=1.0 if name == "adftest" else 0.0)
        row["methods"][name] = {"ms": ms, "launches": got,
                                "share_within_rtol": share,
                                "sane_cpu_lanes": int(ok.sum())}

    # the gradient at the jittered point against its plain version on
    # the card (float32 both, sums in other orders): each lane's error
    # relative to its largest |entry|, so a zero gradient errs by 1.  On
    # the lanes invertible there: where the MA part is not invertible the
    # residual recursion amplifies each rounding without bound
    g_kern = mj.gradient_log_likelihood_css_arma(d)
    _, g_plain = arma_ne.css_neg_ll_value_and_grad_plain(
        mj.coefficients, d, 2, 2, 1)
    g_plain = -g_plain.double()               # ∇LL = −∇(−LL)
    scale = g_plain.abs().amax(dim=1)
    err = ((g_kern.double() - g_plain).abs().amax(dim=1) / scale)
    inv = torch.as_tensor(mj.is_invertible(), device=dev)
    g_fit = model.gradient_log_likelihood_css_arma(d).double().abs() \
        .amax(dim=1)
    row["methods"][grad].update(
        jitter_sd=SURF_GRAD_JITTER,
        vs_plain_share=float((err[inv] <= NE_TOL).double().mean()),
        vs_plain_max_err=float(err[inv].max()),
        vs_plain_invertible_share=float(inv.double().mean()),
        median_max_abs_grad=float(scale[inv].median()),
        median_max_abs_grad_at_fit=float(g_fit[inv].median()))

    # refit_unconverged: the capped fit's unconverged lanes, gathered
    (got_model, got) = counted(lambda: base.refit_unconverged(y, model,
                                                              refit))
    ms = _event_ms(lambda: base.refit_unconverged(y, model, refit), 2)
    ref_model = base.refit_unconverged(y64, m64._replace(
        diagnostics=model.diagnostics._replace(
            converged=model.diagnostics.converged[:L].cpu(),
            n_iter=model.diagnostics.n_iter[:L].cpu(),
            fun=model.diagnostics.fun[:L].cpu().double())), refit)
    # the refitted lanes sit on flat ridges, where float32 and float64 end
    # at other points of one valley: their objectives are compared
    unconv = ~model.diagnostics.converged[:L].cpu().numpy()
    both = got_model.diagnostics.converged[:L].cpu().numpy() \
        & ref_model.diagnostics.converged.numpy() & unconv
    f32 = got_model.diagnostics.fun[:L].cpu().double().numpy()[both]
    f64 = ref_model.diagnostics.fun.numpy()[both]
    row["methods"]["refit_unconverged"] = {
        "ms": ms, "launches": got,
        "refitted_lanes": int((~model.diagnostics.converged).sum()),
        "converged_after": float(got_model.diagnostics.converged.double()
                                 .mean()),
        "cpu_both_converged": int(both.sum()),
        "fun_share_within_rtol": float(np.mean(
            np.abs(f32 - f64) <= SURF_RTOL * np.abs(f64))) if f64.size
        else None}

    # one stepwise auto_fit per series, against the CPU's
    t_ms, same, got_all = [], 0, {"arma_lm_fit": 0, "arma_ne": 0,
                                  "arma_css": 0}
    for i in range(SURF_AUTO_SERIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        am, got = counted(lambda: arima.auto_fit(y[i], max_p=2, max_q=2,
                                                 device=dev))
        end.record()
        end.synchronize()
        t_ms.append(start.elapsed_time(end))
        for k2, v in got.items():
            got_all[k2] += v
        ref_am = arima.auto_fit(y64[i], max_p=2, max_q=2, device="cpu")
        same += (am.p, am.d, am.q, am.has_intercept) \
            == (ref_am.p, ref_am.d, ref_am.q, ref_am.has_intercept)
    row["methods"]["auto_fit"] = {
        "ms": float(np.median(t_ms)), "series": SURF_AUTO_SERIES,
        "launches": got_all, "orders_equal_share": same / SURF_AUTO_SERIES}
    row["launches"] = totals
    row["widths"] = widths
    emit(row)

    for name, m in row["methods"].items():
        if "share_within_rtol" in m:
            check(m["share_within_rtol"] >= SURF_SHARE,
                  f"{name}: only {m['share_within_rtol']:.4f} of the sane "
                  f"lanes agree with the float64 CPU run to {SURF_RTOL:g}")
    ms_ = row["methods"]
    check(ms_["approx_aic"]["launches"]["arma_css"] == 1,
          "approx_aic did not run the cost-only kernel once")
    check(ms_["gradient_log_likelihood_css_arma"]["launches"]["arma_ne"]
          == 1, "the gradient did not run the single-pass kernel once")
    check(ms_[grad]["vs_plain_share"] >= SURF_SHARE,
          "the gradient through arma_ne differs from its plain version on "
          "more than 1 % of the invertible lanes")
    rf = ms_["refit_unconverged"]
    check(rf["launches"]["arma_lm_fit"] == 1 and (
        rf["fun_share_within_rtol"] is None
        or rf["fun_share_within_rtol"] >= AGREE[1][1]),
          f"refit_unconverged: {rf}")
    check(ms_["auto_fit"]["orders_equal_share"] >= SURF_AUTO_FLOOR,
          f"the stepwise auto_fit chose the CPU's orders on only "
          f"{ms_['auto_fit']['orders_equal_share']:.2f} of the series")
    return row


# ---------------------------------------------------------------------------
# slice 9: the volatility and smoothing families, the fail-soft
# Holt-Winters panel and css-cgd
# ---------------------------------------------------------------------------

VOL_N_SERIES = 65536      # BASELINE config #4's minute-bar shape, widened
VOL_N_OBS = 1024
VOL_CHUNK = 16384         # a GARCH Newton chunk's autograd graph: ~7 GB
VOL_FAMILIES = ("garch", "argarch", "egarch")
VOL_REF_LANES = 256       # lanes each family refits on the CPU in float64
VOL_LL_RTOL = 1e-5        # float64 neg-LL at the card's parameters
VOL_AGREE_FLOOR = 0.90
VOL_BAD_SHARE = 0.002     # each kind of pathological row, resilient chunk
VOL_SHORT_WINDOW = 2      # a too-short row's valid steps (min_len 3)
VOL_DESCENT_RTOL = 3e-3   # float32 descent's neg-LL vs the f64 Newton's:
# a first-order descent in float32 stops where its steps no longer move
# the neg-LL, ~1e-4 above the optimum
EWMA_N_SERIES = 1_048_576
EWMA_N_OBS = 128
EWMA_REF_LANES = 1024
EWMA_TOL = 1e-4
EWMA_AGREE_FLOOR = 0.90
HWR_BAD_SHARE = 0.002
HWR_SHORT_WINDOW = 20     # under 2·12 + 1 = 25 steps
HWR_ROUTE_LANES = 4096
HWR_ROUTE_MAX_ITER = 30   # the route check's per-attempt budget
HWR_ROUTE_SHARE = (0.95, 0.95)
CGD_LANES = 256           # BFGS over arma_ne vs over the plain pass
CGD_LM_RTOL = 1e-4
CGD_LM_FLOOR = 0.90
CGD_PLAIN_RTOL = 1e-5
CGD_PLAIN_FLOOR = 0.90


def synthetic_vol_panel(n_series: int, n_obs: int, seed: int = 0,
                        c=0.1, phi=0.3, omega=0.05, alpha=0.1, beta=0.85):
    """AR(1)+GARCH(1,1) draws of BASELINE config #4's generator
    (``benchmarks/bench_suite.py:352-357``, ``ARGARCHModel.sample``: index
    0 stays 0, the variance starts at ``ω / (1 - α - β)``), float32."""
    rng = np.random.default_rng([seed, 9])
    out = np.empty((n_series, n_obs), np.float32)
    var = np.full(n_series, omega / (1.0 - alpha - beta))
    eta = np.sqrt(var) * rng.standard_normal(n_series)
    y = np.zeros(n_series)
    out[:, 0] = 0.0
    for i in range(1, n_obs):
        var = omega + beta * var + alpha * eta * eta
        eta = np.sqrt(var) * rng.standard_normal(n_series)
        y = c + phi * y + eta
        out[:, i] = y
    return out


def synthetic_ewma_panel(n_series: int, n_obs: int, seed: int = 0):
    """BASELINE config #1's recipe: a cumulative sum of N(0, 1) plus 100
    (``benchmarks/bench_suite.py:321-324``), float32."""
    rng = np.random.default_rng([seed, 10])
    out = rng.standard_normal((n_series, n_obs), dtype=np.float32)
    np.cumsum(out, axis=1, out=out)
    out += 100.0
    return out


def _vol_ref_part(seed: int, families):
    """The float64 CPU fits of the first ``VOL_REF_LANES`` series of the
    volatility panel (in a spawned process)."""
    import torch

    from spark_timeseries_tpu_torch.models import garch

    torch.set_num_threads(1)
    values = synthetic_vol_panel(VOL_N_SERIES, VOL_N_OBS, seed)[
        :VOL_REF_LANES].astype(np.float64)
    fits = {"garch": garch.fit, "argarch": garch.fit_ar_garch,
            "egarch": garch.fit_egarch}
    out = {}
    for family in families:
        t0 = time.perf_counter()
        m = fits[family](values, device="cpu")
        out[family] = {"fun": m.diagnostics.fun.numpy(),
                       "converged": m.diagnostics.converged.numpy(),
                       "seconds": time.perf_counter() - t0}
    return out


def start_vol_ref(seed: int):
    """Start the float64 CPU volatility fits in two spawned processes
    (EGARCH, the slow one, alone); returns ``(pool, [pending...])``."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(2)
    pending = [pool.apply_async(_vol_ref_part, (seed, fams))
               for fams in (("garch", "argarch"), ("egarch",))]
    return pool, pending


def _vol_neg_ll64(family: str, model, values: np.ndarray) -> np.ndarray:
    """The float64 negative log likelihood of ``values`` at a fitted
    model's parameters (the fit's own objective: AR-GARCH's on the AR(1)
    residuals)."""
    import torch

    from spark_timeseries_tpu_torch.models import autoregression, garch

    v = torch.from_numpy(values.astype(np.float64))
    p = {f: getattr(model, f).double().cpu()
         for f in model._fields if f != "diagnostics"}
    if family == "garch":
        return -garch.GARCHModel(p["omega"], p["alpha"], p["beta"]) \
            .log_likelihood(v).numpy()
    if family == "egarch":
        return -garch.EGARCHModel(p["omega"], p["alpha"], p["beta"],
                                  p["gamma"]).log_likelihood(v).numpy()
    resid = autoregression.ARModel(p["c"], p["phi"][:, None]) \
        .remove_time_dependent_effects(v)
    return -garch.GARCHModel(p["omega"], p["alpha"], p["beta"]) \
        .log_likelihood(resid).numpy()


def bad_rows(S: int, n: int, share: float, short_window: int, seed: int,
             stream: int):
    """Disjoint rows, ``share`` of ``S`` each, for the resilient phases:
    all-NaN, constant, one inf, too short (only the last ``short_window``
    steps observed)."""
    rng = np.random.default_rng([seed, stream])
    k = max(1, int(S * share))
    order = rng.permutation(S)
    kinds = ("all_nan", "constant", "has_inf", "too_short")
    rows = {kind: np.sort(order[i * k:(i + 1) * k])
            for i, kind in enumerate(kinds)}
    cols = rng.integers(0, n, k)
    return rows, cols


def with_bad_rows(values: np.ndarray, rows, inf_cols, short_window: int):
    out = values.copy()
    out[rows["all_nan"]] = np.nan
    out[rows["constant"]] = out[rows["constant"], :1]
    out[rows["has_inf"], inf_cols] = np.inf
    out[rows["too_short"], :values.shape[1] - short_window] = np.nan
    return out


def _cat_models(models):
    """Per-chunk models of one family, concatenated along the lanes."""
    import torch

    def cat(vals):
        if isinstance(vals[0], torch.Tensor):
            return torch.cat(vals)
        if isinstance(vals[0], tuple):
            return type(vals[0])(*(cat([v[i] for v in vals])
                                   for i in range(len(vals[0]))))
        return vals[0]

    return cat(list(models))


def egarch_descent_stage(engine, bad: np.ndarray, dev):
    """The EGARCH fail-soft chain's descent stage on the card: the
    resilient first chunk again, under a ``force_nonconverge`` fault that
    fails every Newton attempt (the first and the policy's restarts), so
    that every fittable lane reaches the descent.  The stage's own call
    is timed, and its peak of allocated memory read, by wrapping
    ``garch.fit_egarch`` for the call's duration.  Returns the row and
    the descent's model over the fittable rows, and those rows."""
    import torch

    from spark_timeseries_tpu_torch.models import garch as garch_mod
    from spark_timeseries_tpu_torch.utils import resilience as res_mod

    real = garch_mod.fit_egarch
    cap = {}

    def probe(v, *args, **kwargs):
        if kwargs.get("method") != "descent":
            return real(v, *args, **kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = real(v, *args, **kwargs)
        torch.cuda.synchronize()
        cap.update(seconds=time.perf_counter() - t0, lanes=v.shape[0],
                   allocated_before_gib=before / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   peak_reserved_gib=torch.cuda.max_memory_reserved()
                   / 2**30, model=m)
        return m

    n_att = res_mod.RetryPolicy().max_restarts + 1
    garch_mod.fit_egarch = probe
    try:
        t0 = time.perf_counter()
        with res_mod.fault_injection("force_nonconverge", n_attempts=n_att):
            _, out = engine.fit_resilient(bad, "egarch", device=dev)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
    finally:
        garch_mod.fit_egarch = real
    fittable = int((out.status != res_mod.STATUS_SKIPPED).sum())
    model = cap.pop("model", None)
    n_iter = None if model is None else \
        model.diagnostics.n_iter.cpu().numpy()
    row = {"fault_n_attempts": n_att, "chain_s": chain_s,
           "statuses": out.counts(), "fittable_lanes": fittable,
           **{f"descent_{k}": v for k, v in cap.items()},
           "descent_median_n_iter": None if n_iter is None
           else float(np.median(n_iter)),
           "descent_max_n_iter": None if n_iter is None
           else int(n_iter.max())}
    rows = np.flatnonzero(out.status != res_mod.STATUS_SKIPPED)
    check(model is not None and cap["lanes"] == fittable,
          f"egarch descent stage: ran on {cap.get('lanes')} lanes, "
          f"{fittable} fittable")
    check(out.counts().get("fallback", 0) == fittable
          and bool((out.fallback_used[out.status
                                      != res_mod.STATUS_SKIPPED] == 2)
                   .all()),
          f"egarch under the fault: every fittable lane should end at the "
          f"constant-log-variance stage, got {out.counts()}")
    return row, model, rows


def phase_vol_path(seed, dev, vol_ref, chunk=VOL_CHUNK):
    """The volatility families on the card: for each of GARCH, AR-GARCH
    and EGARCH, ``FitEngine().stream_fit`` of the 65,536 x 1024 panel in
    ``chunk``-series chunks, ``Panel.stream_fit`` of its first chunk
    (bitwise), the first chunk with pathological rows through
    ``FitEngine.fit_resilient`` (skipped = the unfittable rows, health =
    the CPU's, OK lanes = the plain fit of the same rows, bitwise), for
    EGARCH the chain's descent stage (:func:`egarch_descent_stage`), and
    the first 256 lanes' objectives against float64 CPU fits."""
    import torch

    from spark_timeseries_tpu_torch import Panel
    from spark_timeseries_tpu_torch import time as ttime
    from spark_timeseries_tpu_torch.engine import FitEngine, _fit_values
    from spark_timeseries_tpu_torch.utils import resilience as res_mod

    panel = synthetic_vol_panel(VOL_N_SERIES, VOL_N_OBS, seed)
    S, n = panel.shape
    rows, inf_cols = bad_rows(chunk, n, VOL_BAD_SHARE, VOL_SHORT_WINDOW,
                              seed, 12)
    part = panel[:chunk]
    bad = with_bad_rows(part, rows, inf_cols, VOL_SHORT_WINDOW)
    index = ttime.uniform("2024-01-02T09:30Z", n, ttime.MinuteFrequency(1))
    skipped_rows = np.sort(np.concatenate(
        [rows[k] for k in ("all_nan", "has_inf", "too_short")]))
    cpu_health = res_mod.classify_series(torch.from_numpy(bad),
                                         min_len=3).numpy()
    out = {"phase": "vol_path", "n_series": S, "n_obs": n,
           "chunk_size": chunk, "families": {}}
    engine = FitEngine()
    for family in VOL_FAMILIES:
        row = {}
        torch.cuda.synchronize()
        res = engine.stream_fit(panel, family, chunk_size=chunk, device=dev,
                                collect=True)
        check(not res.chunk_failures,
              f"{family}: chunk failures "
              f"{[f['error'] for f in res.chunk_failures]}")
        model = _cat_models(res.models)
        row.update(wall_s=res.wall_s, series_per_s=res.rate,
                   n_chunks=res.n_chunks,
                   chunk_wall_s=res.wall_s / res.n_chunks,
                   converged_pct=100.0 * res.n_converged / S,
                   solver_iterations_per_chunk=res.stats[
                       "solver_iterations"],
                   median_n_iter=float(model.diagnostics.n_iter.double()
                                       .median()))
        # the Panel over the first chunk's rows: the same fit, bitwise
        tp = Panel(index, torch.from_numpy(part).to(dev),
                   [f"s{i}" for i in range(chunk)], device=dev)
        t0 = time.perf_counter()
        pres = tp.stream_fit(family, chunk_size=chunk, collect=True)
        row["panel_chunk_s"] = time.perf_counter() - t0
        row["panel_bitwise_stream"] = _model_bitwise(pres.models[0],
                                                      res.models[0])
        # the resilient first chunk
        t0 = time.perf_counter()
        rmodel, rout = engine.fit_resilient(bad, family, device=dev)
        torch.cuda.synchronize()
        row["resilient_chunk_s"] = time.perf_counter() - t0
        row["resilient_statuses"] = rout.counts()
        vals, counts = np.unique(rout.attempts, return_counts=True)
        row["resilient_attempts"] = {int(a): int(c)
                                     for a, c in zip(vals, counts)}
        skipped = rout.status == res_mod.STATUS_SKIPPED
        row["skipped_is_unfittable"] = bool(np.array_equal(
            np.flatnonzero(skipped), skipped_rows))
        row["health_bitwise_cpu"] = _bitwise_equal(rout.health, cpu_health)
        safe = bad.copy()
        safe[skipped] = res_mod._placeholder_rows(n, bad.dtype)
        plain = _fit_values(family, (), torch.from_numpy(safe).to(dev))
        ok = rout.status == res_mod.STATUS_OK
        params = [f for f in plain._fields if f != "diagnostics"]
        row["ok_lanes"] = int(ok.sum())
        row["ok_bitwise_plain"] = all(_bitwise_equal(
            getattr(rmodel, f).cpu().numpy()[ok],
            getattr(plain, f).cpu().numpy()[ok]) for f in params)
        if family == "egarch":
            row["descent_stage"], dmodel, drows = egarch_descent_stage(
                engine, bad, dev)
        out["families"][family] = row
        emit({"phase": "vol_path_family", "family": family, **row})
        check(row["panel_bitwise_stream"],
              f"{family}: Panel.stream_fit differs from the engine's")
        check(row["skipped_is_unfittable"] and row["health_bitwise_cpu"],
              f"{family}: skipped lanes are not the unfittable rows, or "
              f"health codes differ from the CPU's")
        check(row["ok_lanes"] > 0 and row["ok_bitwise_plain"],
              f"{family}: OK lanes differ from the plain fit")
        check(all(np.isfinite(getattr(model, f).cpu().numpy()).all()
                  for f in params), f"{family}: non-finite parameters")
        out["families"][family]["_model"] = model

    # the float64 CPU fits of the first lanes, by objective
    pool, pending = vol_ref
    t0 = time.perf_counter()
    ref = {}
    for p in pending:
        ref.update(p.get(timeout=900))
    out["ref_waited_s"] = time.perf_counter() - t0
    pool.close()
    pool.join()
    k = VOL_REF_LANES
    for family in VOL_FAMILIES:
        row = out["families"][family]
        model = row.pop("_model")
        sub = type(model)(*(v[:k] if hasattr(v, "shape") else v
                            for v in model[:-1]), None)
        card = _vol_neg_ll64(family, sub, panel[:k])
        r = ref[family]
        both = model.diagnostics.converged[:k].cpu().numpy() & r["converged"]
        rel = np.abs(card - r["fun"]) / np.abs(r["fun"])
        share = float(np.mean(rel[both] <= VOL_LL_RTOL)) if both.any() \
            else 0.0
        row.update(ref_cpu_f64_s=r["seconds"],
                   ref_both_converged=int(both.sum()),
                   ref_neg_ll_agree_share=share,
                   ref_median_rel_neg_ll=float(np.median(rel[both]))
                   if both.any() else None)
        check(share >= VOL_AGREE_FLOOR,
              f"{family}: only {share:.3f} of {int(both.sum())} lanes "
              f"converged in both have a float64 neg-LL at the card's "
              f"parameters within {VOL_LL_RTOL:g} of the float64 fit's "
              f"(floor {VOL_AGREE_FLOOR})")
    # the descent stage's lanes among the first k clean rows, against the
    # float64 CPU Newton optimum of the same rows
    row = out["families"]["egarch"]["descent_stage"]
    touched = np.concatenate(list(rows.values()))
    sel = np.flatnonzero((drows < k) & ~np.isin(drows, touched))
    sub = type(dmodel)(*(v[sel] for v in dmodel[:-1]), None)
    lanes = drows[sel]
    card = _vol_neg_ll64("egarch", sub, panel[lanes])
    r = ref["egarch"]
    conv = r["converged"][lanes]
    gap = (card - r["fun"][lanes]) / np.abs(r["fun"][lanes])
    share = float(np.mean(np.abs(gap[conv]) <= VOL_DESCENT_RTOL)) \
        if conv.any() else 0.0
    row.update({"ref_lanes": int(conv.sum()), "ref_share": share,
                "ref_share_within_1e-5": float(np.mean(
                    np.abs(gap[conv]) <= VOL_LL_RTOL)) if conv.any() else 0.0,
                "ref_median_rel_gap": float(np.median(gap[conv]))
                if conv.any() else None})
    check(share >= VOL_AGREE_FLOOR,
          f"egarch descent stage: only {share:.3f} of {int(conv.sum())} "
          f"lanes end within {VOL_DESCENT_RTOL:g} of the float64 CPU "
          f"Newton neg-LL (floor {VOL_AGREE_FLOOR})")
    emit(out)
    return out


def phase_ewma_path(seed, dev, chunk=CHUNK):
    """EWMA on the card: ``FitEngine().stream_fit(values, "ewma")`` of a
    1,048,576 x 128 random-walk panel (BASELINE config #1's recipe) in
    131072-series chunks, its first 1024 lanes against the float64 CPU
    fit."""
    import torch

    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import ewma

    panel = synthetic_ewma_panel(EWMA_N_SERIES, EWMA_N_OBS, seed)
    engine = FitEngine()
    engine.stream_fit(panel[:4096], "ewma", chunk_size=4096, device=dev)
    res = engine.stream_fit(panel, "ewma", chunk_size=chunk, device=dev,
                            collect=True)
    check(not res.chunk_failures,
          f"ewma: chunk failures {[f['error'] for f in res.chunk_failures]}")
    a = torch.cat([m.smoothing for m in res.models]).numpy()
    conv = torch.cat([m.diagnostics.converged for m in res.models]).numpy()
    k = EWMA_REF_LANES
    t0 = time.perf_counter()
    ref = ewma.fit(panel[:k].astype(np.float64), device="cpu")
    ref_s = time.perf_counter() - t0
    both = conv[:k] & ref.diagnostics.converged.numpy()
    diff = np.abs(a[:k] - ref.smoothing.numpy())
    share = float(np.mean(diff[both] <= EWMA_TOL)) if both.any() else 0.0
    row = {"phase": "ewma_path", "n_series": res.n_series,
           "n_obs": EWMA_N_OBS, "chunk_size": chunk,
           "n_chunks": res.n_chunks, "wall_s": res.wall_s,
           "series_per_s": res.rate,
           "converged_pct": 100.0 * res.n_converged / res.n_series,
           "solver_iterations_per_chunk": res.stats["solver_iterations"],
           "ref_lanes": k, "ref_cpu_f64_s": ref_s,
           "ref_both_converged": int(both.sum()),
           "ref_agree_share": share,
           "ref_max_abs_diff": float(diff[both].max()) if both.any()
           else None}
    emit(row)
    check(bool(np.isfinite(a).all() and (a[conv] >= 1e-4).all()
               and (a[conv] <= 1.0).all()),
          "ewma smoothing not finite or outside [1e-4, 1]")
    check(share >= EWMA_AGREE_FLOOR,
          f"ewma: only {share:.3f} of {int(both.sum())} lanes converged in "
          f"both within {EWMA_TOL:g} of the float64 smoothing (floor "
          f"{EWMA_AGREE_FLOOR})")
    return row


def hw_restart_route_check(part: np.ndarray, lanes: np.ndarray, dev):
    """The Holt-Winters restart driver over ``hw_box_fit`` against the
    same driver over the ``minimize_box`` route over ``hw_sse`` (a launch
    per trial), on the given rows, with the same draws and a per-attempt
    budget of ``HWR_ROUTE_MAX_ITER`` iterations (the monthly panel's
    lanes rarely restart at the default budget)."""
    import torch

    from spark_timeseries_tpu_torch.models import holt_winters as hw_mod
    from spark_timeseries_tpu_torch.ops import hw_sse, optimize
    from spark_timeseries_tpu_torch.utils.resilience import RetryPolicy

    if lanes.size == 0:
        return {"lanes": 0}
    v = torch.from_numpy(part[lanes]).to(dev)
    inp = hw_sse.prepare(v, HW_PERIOD, "additive")
    pol = RetryPolicy()
    x0 = torch.tensor((0.3, 0.1, 0.1), device=dev).expand(v.shape[0], 3)
    draws = optimize.restart_draws(pol.max_restarts, v.shape[0], 3,
                                   torch.float32, dev, pol.seed)

    def driver(route):
        def solve(xs, idx):
            sub = inp if idx is None else hw_mod._gather_inputs(inp, idx)
            if route:
                return optimize.minimize_box(hw_sse.evaluator(sub), xs, 0.0,
                                             1.0, tol=1e-10,
                                             max_iter=HWR_ROUTE_MAX_ITER)[:4]
            return hw_sse.box_fit(sub, xs, 0.0, 1.0, tol=1e-10,
                                  max_iter=HWR_ROUTE_MAX_ITER)[0][:4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = optimize.solve_with_restarts(solve, x0, pol.max_restarts,
                                         pol.perturb_scale,
                                         jitter_draws=draws)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    b0 = hw_sse.box_fit.launches
    kern, kern_s = driver(False)
    kern_launches = hw_sse.box_fit.launches - b0
    s0 = hw_sse.value_and_grad.launches
    route, route_s = driver(True)
    agree = _box_agreement(kern, route)
    agree.update(lanes=int(lanes.size), max_iter=HWR_ROUTE_MAX_ITER,
                 restarted_lanes=int((kern.attempts > 1).sum()),
                 kernel_s=kern_s, route_s=route_s,
                 kernel_box_fit_launches=kern_launches,
                 route_hw_sse_launches=hw_sse.value_and_grad.launches - s0,
                 attempts_equal=float((kern.attempts == route.attempts)
                                      .double().mean()))
    return agree


def phase_hw_resilient_path(hw_panel, plain_converged_pct, seed, dev,
                            chunk=CHUNK):
    """The fail-soft Holt-Winters panel: the monthly panel with
    pathological rows through ``FitEngine().stream_fit(resilient=True,
    retry=RetryPolicy())``, its ``hw_box_fit`` launches counted over
    exactly that run; its first chunk against ``fit_resilient`` and
    ``Panel.fit_resilient`` (bitwise), the restart driver over the
    kernel against the one over the route."""
    import torch

    from spark_timeseries_tpu_torch import Panel
    from spark_timeseries_tpu_torch import time as ttime
    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import holt_winters
    from spark_timeseries_tpu_torch.ops import hw_sse
    from spark_timeseries_tpu_torch.utils import resilience as res_mod

    S, n = hw_panel.shape
    rows, inf_cols = bad_rows(S, n, HWR_BAD_SHARE, HWR_SHORT_WINDOW, seed,
                              13)
    panel = with_bad_rows(hw_panel, rows, inf_cols, HWR_SHORT_WINDOW)
    kw = dict(period=HW_PERIOD, model_type="additive",
              retry=res_mod.RetryPolicy())
    engine = FitEngine()
    engine.stream_fit(panel[:4096], "holt_winters", chunk_size=4096,
                      device=dev, resilient=True, **kw)
    hw_sse.box_fit.launches = 0
    hw_sse.value_and_grad.launches = 0
    res = engine.stream_fit(panel, "holt_winters", chunk_size=chunk,
                            device=dev, resilient=True, collect=True, **kw)
    launches = hw_sse.box_fit.launches
    sse_launches = hw_sse.value_and_grad.launches
    st = res.stats
    statuses = st["resilient_statuses"]
    usable = sum(statuses.get(k, 0) for k in ("ok", "retried", "fallback"))
    row = {"phase": "hw_resilient_path", "n_series": S, "n_obs": n,
           "chunk_size": chunk, "n_chunks": res.n_chunks,
           "pathological_rows": {k: int(v.size) for k, v in rows.items()},
           "wall_s": res.wall_s, "series_per_s": res.rate,
           "statuses": statuses, "usable_pct": 100.0 * usable / S,
           "plain_hw_path_converged_pct": plain_converged_pct,
           "attempts_histogram": st["resilient_attempts"],
           "box_fit_launches_per_chunk": st["box_fit_launches"],
           "box_fit_launches_by_stage_per_chunk":
               st["box_fit_launches_by_stage"],
           "restart_lanes_per_chunk": st["restart_lanes"],
           "hw_box_fit_launches": launches, "hw_sse_launches": sse_launches}
    part = panel[:chunk]
    part_dev = torch.from_numpy(part).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct, out = holt_winters.fit_resilient(
        part_dev, HW_PERIOD, "additive", retry=res_mod.RetryPolicy(),
        device=dev)
    torch.cuda.synchronize()
    row["chunk_fit_resilient_s"] = time.perf_counter() - t0
    row["chunk0_bitwise_direct"] = _model_bitwise(res.models[0], direct)
    index = ttime.uniform("2000-01-01T00:00Z", n, ttime.MonthFrequency(1))
    tp = Panel(index, part_dev, [f"s{i}" for i in range(chunk)], device=dev)
    p_model, p_out = tp.fit_resilient("holt_winters", HW_PERIOD, "additive",
                                      retry=res_mod.RetryPolicy())
    row["panel_bitwise_direct"] = _model_bitwise(p_model, direct) \
        and bool(np.array_equal(p_out.status, out.status))
    skipped = res_mod.unfittable_mask(out.health)
    healthy = np.flatnonzero(~skipped)[:HWR_ROUTE_LANES]
    row["restart_vs_route"] = hw_restart_route_check(part, healthy, dev)
    emit(row)

    check(not res.chunk_failures,
          f"chunk failures: {[f['error'] for f in res.chunk_failures]}")
    check(launches > 0 and launches == sum(st["box_fit_launches"]),
          f"the resilient Holt-Winters path launched hw_box_fit {launches} "
          f"times, its stages counted {sum(st['box_fit_launches'])}")
    check(sse_launches == 0, f"the resilient Holt-Winters path launched "
                             f"hw_sse {sse_launches} times")
    check(statuses.get("skipped", 0) == sum(
        rows[k].size for k in ("all_nan", "has_inf", "too_short")),
          f"skipped {statuses.get('skipped', 0)} lanes, not the "
          f"unfittable rows")
    check(row["chunk0_bitwise_direct"],
          "stream_fit(resilient=True)'s first chunk differs from "
          "holt_winters.fit_resilient")
    check(row["panel_bitwise_direct"],
          "Panel.fit_resilient differs from holt_winters.fit_resilient")
    rv = row["restart_vs_route"]
    check(rv["lanes"] > 0 and rv.get("restarted_lanes", 0) > 0
          and rv["n_iter_equal"] >= HWR_ROUTE_SHARE[0]
          and rv["fun_within_1e-5"] >= HWR_ROUTE_SHARE[1],
          f"the Holt-Winters restart driver over the kernel agrees with "
          f"the route on n_iter {rv.get('n_iter_equal', 0.0):.4f} / fun "
          f"{rv.get('fun_within_1e-5', 0.0):.4f} of {rv['lanes']} lanes "
          f"(floors {HWR_ROUTE_SHARE})")
    return row


def phase_css_cgd_path(panel, dev, chunk=CHUNK):
    """``arima.fit(2, 1, 2, chunk, method="css-cgd")`` on the first chunk
    of the north-star panel: one ``arma_ne`` launch per BFGS evaluation
    (counted against ``stats["ne_launches"]``), its neg-LL against the
    css-lm fit of the same chunk, and on 256 lanes the BFGS over the
    kernel against the BFGS over the plain pass, both on the card."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne, optimize
    from spark_timeseries_tpu_torch.ops.univariate import \
        differences_of_order_d

    part = torch.from_numpy(panel[:chunk]).to(dev)
    arima.fit(2, 1, 2, part[:1024], method="css-cgd", warn=False,
              device=dev)                      # warm-up, not counted
    arma_ne.normal_equations.launches = 0
    arma_ne.normal_equations.widths.clear()
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cgd = arima.fit(2, 1, 2, part, method="css-cgd", warn=False, device=dev,
                    stats=st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = arma_ne.normal_equations.launches
    widths = _widths(arma_ne.normal_equations)
    lm = arima.fit(2, 1, 2, part, warn=False, device=dev)
    fin_lm = torch.isfinite(lm.coefficients).all(dim=-1).cpu().numpy()
    nll_cgd = (-cgd.log_likelihood_css(part)).double().cpu().numpy()
    nll_lm = (-lm.log_likelihood_css(part)).double().cpu().numpy()
    sane = np.isfinite(nll_cgd) & np.isfinite(nll_lm)
    rel = np.abs(nll_cgd - nll_lm) / np.abs(nll_lm)
    lm_share = float(np.mean(rel[sane] <= CGD_LM_RTOL))
    # the BFGS over the kernel against the BFGS over the plain pass
    k = CGD_LANES
    diffed = differences_of_order_d(part[:k], 1)[..., 1:]
    x0 = arima.hannan_rissanen_init(2, 2, diffed, True)

    def bfgs(vag_fn):
        def ev_for(idx):
            y = diffed if idx is None else diffed.index_select(0, idx)
            return lambda x: vag_fn(x, y, 2, 2, 1)
        return optimize.minimize_bfgs(ev_for(None), x0, max_iter=500,
                                      evaluator_for=ev_for)

    kern = bfgs(arma_ne.css_neg_ll_value_and_grad)
    plain = bfgs(arma_ne.css_neg_ll_value_and_grad_plain)
    frel = ((kern.fun.double() - plain.fun.double()).abs()
            / plain.fun.double().abs()).cpu().numpy()
    fin = np.isfinite(frel)
    plain_share = float(np.mean(frel[fin] <= CGD_PLAIN_RTOL)) \
        if fin.any() else 0.0
    n_iter = cgd.diagnostics.n_iter.cpu().numpy()
    row = {"phase": "css_cgd_path", "n_series": chunk, "n_obs": N_OBS,
           "ms": ms, "series_per_s": chunk / (ms / 1e3),
           "arma_ne_launches": launches, "stats_ne_launches":
               st["ne_launches"], "arma_ne_widths": widths,
           "bfgs_iterations_max": int(n_iter.max()),
           "bfgs_iterations_median": float(np.median(n_iter)),
           "converged_pct": float(100.0 * cgd.diagnostics.converged
                                  .double().mean()),
           "lm_converged_pct": float(100.0 * lm.diagnostics.converged
                                     .double().mean()),
           "vs_lm_lanes": int(sane.sum()), "vs_lm_share": lm_share,
           "vs_lm_floor": CGD_LM_FLOOR,
           "vs_lm_floor_met": lm_share >= CGD_LM_FLOOR,
           "vs_lm_median_rel": float(np.median(rel[sane])),
           "cgd_worse_share": float(np.mean(
               (nll_cgd > nll_lm * (1 + CGD_LM_RTOL))[sane])),
           "cgd_better_share": float(np.mean(
               (nll_cgd < nll_lm * (1 - CGD_LM_RTOL))[sane])),
           "worse_lanes_median_bfgs_iterations": float(np.median(
               n_iter[sane & (nll_cgd > nll_lm * (1 + CGD_LM_RTOL))]))
           if (sane & (nll_cgd > nll_lm * (1 + CGD_LM_RTOL))).any()
           else None,
           "vs_plain_lanes": k, "vs_plain_share": plain_share,
           "vs_plain_n_iter_equal": float((kern.n_iter == plain.n_iter)
                                          .double().mean())}
    emit(row)
    # the floor against css-lm is held at the end of main, after the
    # kernels line, so that a miss still prints every measurement
    check(launches > 0 and launches == st["ne_launches"],
          f"css-cgd launched arma_ne {launches} times, its stats counted "
          f"{st['ne_launches']}")
    check(bool(np.isfinite(cgd.coefficients.cpu().numpy()[fin_lm]).all()),
          "css-cgd coefficients not finite where the css-lm fit's are "
          "(the Hannan-Rissanen init's NaN lanes are NaN in both)")
    check(plain_share >= CGD_PLAIN_FLOOR,
          f"the BFGS over arma_ne agrees with the BFGS over the plain pass "
          f"on fun within {CGD_PLAIN_RTOL:g} on {plain_share:.3f} of {k} "
          f"lanes (floor {CGD_PLAIN_FLOOR})")
    return row


# -- slice 10: the exogenous-regressor families and the exact likelihood ---

REG_N_SERIES = 131072     # BASELINE config #5's 8192 series x 16
REG_N_OBS = 256
REG_K = 3
REG_MAX_ITER = 10
REG_REF_LANES = 256
REG_RES_ROWS = 16384      # the resilient check's rows
REG_BAD_SHARE = 0.002
REG_SHORT_WINDOW = 4      # under the chain's min_len k + 3 = 6
REG_DECISION_FLOOR = 0.95
REG_COEF_RTOL = 1e-3
REG_COEF_FLOOR = 0.90
REG_TEST_RTOL = 1e-3
REG_TEST_FLOOR = 0.99
ARX_K = 2                 # shared random-walk regressors of the ARIMAX panel
ARX_LAG = 1
ARX_REF_LANES = 256
ARX_LL_RTOL = 1e-5
ARX_LL_FLOOR = 0.90
ARX_ROUTE_SHARE = (0.95, 0.95)
ARX_SHORT_WINDOW = 10     # under the chain's min_len d + 2·2 + 3 + 4 = 12
EXACT_LANES = CHUNK       # the first chunk of the north-star panel
EXACT_REF_LANES = 256
EXACT_LL_RTOL = 1e-5
EXACT_LL_FLOOR = 0.90
EXACT_CARD_RTOL = 1e-4
EXACT_CARD_LANES = 4096
EXACT_CARD_FLOOR = 0.99


def synthetic_regarima_panel(n_series: int, n_obs: int, seed: int = 0,
                             k: int = REG_K):
    """BASELINE config #5's generator (``benchmarks/bench_suite.py:
    365-375``): ``k`` shared random-walk regressors ``X (n_obs, k)``, one
    shared ``β ~ N(0, 1)``, AR(1) errors at φ = 0.6; float32 ``(y, X)``."""
    rng = np.random.default_rng([seed, 13])
    X = rng.normal(size=(n_obs, k)).cumsum(axis=0)
    beta = rng.normal(size=k)
    e = np.zeros((n_series, n_obs), np.float32)
    w = rng.standard_normal((n_series, n_obs), dtype=np.float32)
    for t in range(1, n_obs):
        e[:, t] = 0.6 * e[:, t - 1] + w[:, t]
    return (e + (X @ beta).astype(np.float32)[None]), X.astype(np.float32)


def arimax_regressors(n_obs: int, seed: int, k: int = ARX_K):
    """``X (n_obs, k)`` shared random walks and ``β (k,)`` from ``seed``,
    float32: the ARIMAX panel is the north-star panel plus ``X @ β``."""
    rng = np.random.default_rng([seed, 14])
    X = rng.normal(size=(n_obs, k)).cumsum(axis=0).astype(np.float32)
    return X, rng.normal(size=k).astype(np.float32)


def _slice10_ref_part(what: str, values: np.ndarray, X):
    """The float64 CPU fits of slice 10's reference lanes (in a spawned
    process): ``"arimax"`` the ARIMAX(2,1,2) fit, ``"exact"`` the exact
    ARIMA(2,1,2) fit."""
    import torch

    from spark_timeseries_tpu_torch.models import arima, arimax

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    v = values.astype(np.float64)
    if what == "arimax":
        m = arimax.fit(2, 1, 2, v, X.astype(np.float64), ARX_LAG,
                       device="cpu")
    else:
        m = arima.fit(2, 1, 2, v, objective="exact", warn=False,
                      device="cpu")
    return {"coefficients": m.coefficients.numpy(),
            "fun": m.diagnostics.fun.numpy(),
            "converged": m.diagnostics.converged.numpy(),
            "seconds": time.perf_counter() - t0}


def start_slice10_ref(panel: np.ndarray, seed: int):
    """Start the float64 CPU ARIMAX and exact fits of the first lanes of
    the north-star panel (plus ``X @ β`` for ARIMAX) in two spawned
    processes; returns ``(pool, {what: pending})``."""
    import multiprocessing

    X, beta = arimax_regressors(panel.shape[1], seed)
    pool = multiprocessing.get_context("spawn").Pool(2)
    pending = {
        "arimax": pool.apply_async(_slice10_ref_part, (
            "arimax", panel[:ARX_REF_LANES] + X @ beta, X)),
        "exact": pool.apply_async(_slice10_ref_part, (
            "exact", panel[:EXACT_REF_LANES], None))}
    return pool, pending


def phase_regarima_path(seed, dev, n_series=REG_N_SERIES):
    """BASELINE config #5 on the card: ``regression_arima.
    fit_cochrane_orcutt(y, X, 10)``, ``stats.adftest(y, 4)`` and
    ``stats.kpsstest(y, "c")`` over the 131,072 x 256 panel; against the
    port's float64 CPU run of the first 256 lanes; the first 16384 rows
    with pathological rows through ``FitEngine().fit_resilient(...,
    "regression_arima", X)`` and ``Panel.fit_resilient``."""
    import torch

    from spark_timeseries_tpu_torch import Panel, stats
    from spark_timeseries_tpu_torch import time as ttime
    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import regression_arima
    from spark_timeseries_tpu_torch.ops import arma_ne
    from spark_timeseries_tpu_torch.utils import resilience as res_mod

    y, X = synthetic_regarima_panel(n_series, REG_N_OBS, seed)
    S, n = y.shape
    Xd = torch.from_numpy(X).to(dev)
    part = torch.from_numpy(y[:4096]).to(dev)           # warm-up
    regression_arima.fit_cochrane_orcutt(part, Xd, REG_MAX_ITER, device=dev)
    stats.adftest(part, 4)
    stats.kpsstest(part, "c")
    counts0 = (arma_ne.fit_css_lm.launches,
               arma_ne.normal_equations.launches, arma_ne.css_cost.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yd = torch.from_numpy(y).to(dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    st = {}
    t1 = time.perf_counter()
    m = regression_arima.fit_cochrane_orcutt(yd, Xd, REG_MAX_ITER,
                                             device=dev, stats=st)
    torch.cuda.synchronize()
    co_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    adf, adf_p = stats.adftest(yd, 4)
    kpss, _ = stats.kpsstest(yd, "c")
    torch.cuda.synchronize()
    tests_s = time.perf_counter() - t2
    launches = tuple(b - a for a, b in zip(counts0, (
        arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches,
        arma_ne.css_cost.launches)))
    n_iter = m.diagnostics.n_iter.cpu().numpy()
    # the port's float64 CPU run of the first lanes
    k = REG_REF_LANES
    y64 = torch.from_numpy(y[:k].astype(np.float64))
    X64 = torch.from_numpy(X.astype(np.float64))
    t3 = time.perf_counter()
    ref = regression_arima.fit_cochrane_orcutt(y64, X64, REG_MAX_ITER,
                                               device="cpu")
    ref_adf, _ = stats.adftest(y64, 4)
    ref_kpss, _ = stats.kpsstest(y64, "c")
    ref_s = time.perf_counter() - t3
    same = (m.diagnostics.n_iter[:k].cpu().numpy()
            == ref.diagnostics.n_iter.numpy()) \
        & (m.diagnostics.converged[:k].cpu().numpy()
           == ref.diagnostics.converged.numpy())
    card = torch.cat([m.regression_coeff[:k],
                      m.arima_coeff[:k, None]], dim=1).double().cpu()
    want = torch.cat([ref.regression_coeff, ref.arima_coeff[:, None]], dim=1)
    scale = want.abs().amax(dim=1)
    coef_ok = ((card - want).abs().amax(dim=1)
               <= REG_COEF_RTOL * scale).numpy()
    coef_share = float(coef_ok[same].mean()) if same.any() else 0.0

    def test_share(got, ref_stat):
        got = got[:k].double().cpu()
        return float(torch.isclose(got, ref_stat, rtol=REG_TEST_RTOL,
                                   atol=0.0).double().mean())

    adf_share = test_share(adf, ref_adf)
    kpss_share = test_share(kpss, ref_kpss)
    row = {"phase": "regarima_path", "n_series": S, "n_obs": n, "k": REG_K,
           "max_iter": REG_MAX_ITER, "h2d_s": h2d_s,
           "cochrane_orcutt_s": co_s, "adf_kpss_s": tests_s,
           "series_per_s": S / (co_s + tests_s),
           "series_per_s_with_h2d": S / (h2d_s + co_s + tests_s),
           "co_rounds": st["co_rounds"],
           "co_iterations_max": int(n_iter.max()),
           "co_iterations_median": float(np.median(n_iter)),
           "converged_pct": float(100.0 * m.diagnostics.converged.double()
                                  .mean()),
           "rho_median": float(m.arima_coeff.double().median()),
           "adf_reject_5pct_share": float((adf_p < 0.05).double().mean()),
           "arma_lm_fit_launches": launches[0],
           "arma_ne_launches": launches[1],
           "arma_css_launches": launches[2],
           "ref_lanes": k, "ref_cpu_f64_s": ref_s,
           "same_decision_share": float(same.mean()),
           "coef_within_share": coef_share,
           "adf_within_share": adf_share, "kpss_within_share": kpss_share}
    # the resilient first rows
    r = REG_RES_ROWS
    rows, inf_cols = bad_rows(r, n, REG_BAD_SHARE, REG_SHORT_WINDOW, seed,
                              15)
    bad = with_bad_rows(y[:r], rows, inf_cols, REG_SHORT_WINDOW)
    skipped_rows = np.sort(np.concatenate(
        [rows[kk] for kk in ("all_nan", "has_inf", "too_short")]))
    engine = FitEngine()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    rmodel, rout = engine.fit_resilient(bad, "regression_arima", X,
                                        device=dev)
    torch.cuda.synchronize()
    res_s = time.perf_counter() - t4
    skipped = rout.status == res_mod.STATUS_SKIPPED
    cpu_health = res_mod.classify_series(torch.from_numpy(bad),
                                         min_len=REG_K + 3).numpy()
    safe = bad.copy()
    safe[skipped] = res_mod._placeholder_rows(n, bad.dtype)
    plain = regression_arima.fit_cochrane_orcutt(
        torch.from_numpy(safe).to(dev), Xd, REG_MAX_ITER, device=dev)
    ok = rout.status == res_mod.STATUS_OK
    index = ttime.uniform("2020-01-06T00:00Z", n,
                          ttime.BusinessDayFrequency(1))
    tp = Panel(index, torch.from_numpy(bad).to(dev),
               [f"s{i}" for i in range(r)], device=dev)
    pmodel, pout = tp.fit_resilient("regression_arima", X)
    row.update({
        "resilient_rows": r, "resilient_s": res_s,
        "resilient_statuses": rout.counts(),
        "skipped_is_unfittable": bool(np.array_equal(
            np.flatnonzero(skipped), skipped_rows)),
        "health_bitwise_cpu": _bitwise_equal(rout.health, cpu_health),
        "ok_lanes": int(ok.sum()),
        "ok_bitwise_plain": all(_bitwise_equal(
            getattr(rmodel, f).cpu().numpy()[ok],
            getattr(plain, f).cpu().numpy()[ok])
            for f in ("regression_coeff", "arima_coeff")),
        "panel_bitwise_engine": _model_bitwise(pmodel, rmodel)
        and _bitwise_equal(pout.status, rout.status)})
    emit(row)
    check(launches == (0, 0, 0),
          f"regarima_path launched ARMA kernels {launches}")
    check(bool(np.isfinite(m.regression_coeff.cpu().numpy()).all()
               and np.isfinite(adf.cpu().numpy()).all()
               and np.isfinite(kpss.cpu().numpy()).all()),
          "regarima_path: non-finite coefficients or test statistics")
    check(row["same_decision_share"] >= REG_DECISION_FLOOR,
          f"regarima_path: the same Cochrane-Orcutt stopping decision as "
          f"the float64 CPU run on {row['same_decision_share']:.3f} of "
          f"{k} lanes (floor {REG_DECISION_FLOOR})")
    check(coef_share >= REG_COEF_FLOOR,
          f"regarima_path: β and ρ within {REG_COEF_RTOL:g} of the lane's "
          f"largest entry on {coef_share:.3f} of the lanes with the same "
          f"decision (floor {REG_COEF_FLOOR})")
    check(min(adf_share, kpss_share) >= REG_TEST_FLOOR,
          f"regarima_path: ADF / KPSS within {REG_TEST_RTOL:g} of float64 on "
          f"{adf_share:.3f} / {kpss_share:.3f} of lanes (floor "
          f"{REG_TEST_FLOOR})")
    check(row["skipped_is_unfittable"] and row["health_bitwise_cpu"],
          "regarima_path: skipped lanes are not the unfittable rows, or "
          "health codes differ from the CPU's")
    check(row["ok_lanes"] > 0 and row["ok_bitwise_plain"],
          "regarima_path: OK lanes differ from the plain fit")
    check(row["panel_bitwise_engine"],
          "regarima_path: Panel.fit_resilient differs from the engine's")
    return row


def _css_neg_ll64(models, values: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Float64 ARIMAX CSS neg-LL of ``values`` at each model's
    coefficients: the ARMA slice's CSS likelihood on the series adjusted
    by the model's own exogenous part."""
    import torch

    from spark_timeseries_tpu_torch.models import arimax

    coefs = torch.as_tensor(models, dtype=torch.float64)
    m = arimax.ARIMAXModel(2, 1, 2, ARX_LAG, coefs)
    v = torch.from_numpy(values.astype(np.float64))
    diffed = v[:, 1:] - v[:, :-1]
    adjusted = diffed - m.xreg_contribution(X.astype(np.float64))
    return (-m.log_likelihood_css_arma(adjusted)).numpy()


def phase_arimax_path(panel, seed, dev, ref, chunk=CHUNK):
    """ARIMAX(2,1,2) with two shared random-walk regressors (lag 1 and
    the current values) on the card: ``arimax.fit`` (css-lm) of each
    131072-series chunk of the north-star panel plus ``X @ β``, the
    LM-fit kernel once a chunk; the first chunk's refine against
    ``fit_css_lm_route`` on the same adjusted series and starts; the
    first 256 lanes against the float64 CPU fit by objective; the first
    chunk with pathological rows through ``FitEngine().fit_resilient(...,
    "arimax", X, 2, 1, 2, 1, retry=RetryPolicy())``."""
    import torch

    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import arima, arimax
    from spark_timeseries_tpu_torch.ops import arma_ne
    from spark_timeseries_tpu_torch.utils import resilience as res_mod

    X, beta = arimax_regressors(panel.shape[1], seed)
    Xd = torch.from_numpy(X).to(dev)
    shift = X @ beta
    S, n = panel.shape
    arimax.fit(2, 1, 2, torch.from_numpy(panel[:1024] + shift).to(dev), Xd,
               ARX_LAG, device=dev)                  # warm-up, not counted
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    arma_ne.css_cost.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = 0
    first = None
    for s in range(0, S, chunk):
        part = torch.from_numpy(panel[s:s + chunk] + shift).to(dev)
        m = arimax.fit(2, 1, 2, part, Xd, ARX_LAG, device=dev)
        conv += int(m.diagnostics.converged.sum())
        if first is None:
            first = (part, m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (arma_ne.fit_css_lm.launches,
                arma_ne.normal_equations.launches,
                arma_ne.css_cost.launches)
    part, m = first
    # the first chunk's refine against the route on the same inputs
    init, _, adjusted = arimax._refine_inputs(2, 1, 2, part, Xd, ARX_LAG,
                                              True, True)
    kern = arma_ne.fit_css_lm(init, adjusted, 2, 2, 1)
    r0 = arma_ne.normal_equations.launches
    route = arma_ne.fit_css_lm_route(init, adjusted, 2, 2, 1)
    route_launches = arma_ne.normal_equations.launches - r0
    agree = _lm_agreement(kern, route)
    fin = torch.isfinite(kern[0]).all(dim=1, keepdim=True)
    kept = torch.where(fin, kern[0], init)
    refine_is_fit = _bitwise_equal(kept.cpu().numpy(),
                                   m.coefficients[:, :5].cpu().numpy())
    # the model's CSS likelihood and its gradient on the first chunk's
    # adjusted series: one arma_css and one arma_ne launch, counted apart
    c0 = (arma_ne.css_cost.launches, arma_ne.normal_equations.launches)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ll = m.log_likelihood_css_arma(adjusted)
    grad = m.gradient_log_likelihood_css_arma(adjusted)
    torch.cuda.synchronize()
    methods_ms = (time.perf_counter() - t1) * 1e3
    methods_launches = (arma_ne.css_cost.launches - c0[0],
                        arma_ne.normal_equations.launches - c0[1])
    sub = arimax.ARIMAXModel(2, 1, 2, ARX_LAG,
                             m.coefficients[:ARX_REF_LANES].double().cpu())
    ll64 = sub.log_likelihood_css_arma(adjusted[:ARX_REF_LANES].double()
                                       .cpu())
    # an explosive or non-invertible lane's residuals grow until float32
    # rounding sets their leading digits: stationary, invertible lanes
    arma = arima.ARIMAModel(2, 1, 2, sub.arma_coefficients)
    sane = torch.from_numpy(arma.is_stationary() & arma.is_invertible())
    ll_close = float(torch.isclose(ll[:ARX_REF_LANES].double().cpu(), ll64,
                                   rtol=1e-4, atol=0.0)[sane].double().mean())
    # the float64 CPU fit of the first lanes, by objective
    pool, pending = ref
    t1 = time.perf_counter()
    r = pending["arimax"].get(timeout=900)
    waited = time.perf_counter() - t1
    k = ARX_REF_LANES
    vals = panel[:k] + shift
    card = _css_neg_ll64(m.coefficients[:k].cpu().numpy(), vals, X)
    f64 = _css_neg_ll64(r["coefficients"], vals, X)
    both = m.diagnostics.converged[:k].cpu().numpy() & r["converged"]
    rel = np.abs(card - f64) / np.abs(f64)
    ll_share = float(np.mean(rel[both] <= ARX_LL_RTOL)) if both.any() \
        else 0.0
    # the resilient first chunk
    rows, inf_cols = bad_rows(chunk, n, REG_BAD_SHARE, ARX_SHORT_WINDOW,
                              seed, 16)
    bad = with_bad_rows(panel[:chunk] + shift, rows, inf_cols,
                        ARX_SHORT_WINDOW)
    skipped_rows = np.sort(np.concatenate(
        [rows[kk] for kk in ("all_nan", "has_inf", "too_short")]))
    c0 = (arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches)
    arma_ne.normal_equations.widths.clear()
    st = {}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rmodel, rout = FitEngine().fit_resilient(
        bad, "arimax", X, 2, 1, 2, ARX_LAG, retry=res_mod.RetryPolicy(),
        device=dev, stats=st)
    torch.cuda.synchronize()
    res_s = time.perf_counter() - t2
    res_launches = (arma_ne.fit_css_lm.launches - c0[0],
                    arma_ne.normal_equations.launches - c0[1])
    res_widths = _widths(arma_ne.normal_equations)
    skipped = rout.status == res_mod.STATUS_SKIPPED
    min_len = 1 + max(2 * 2 + 3 + 4, ARX_LAG + 2, 3)
    cpu_health = res_mod.classify_series(torch.from_numpy(bad),
                                         min_len=min_len).numpy()
    safe = bad.copy()
    safe[skipped] = res_mod._placeholder_rows(n, bad.dtype)
    plain = arimax.fit(2, 1, 2, torch.from_numpy(safe).to(dev), Xd, ARX_LAG,
                       device=dev)
    ok = rout.status == res_mod.STATUS_OK
    row = {"phase": "arimax_path", "n_series": S, "n_obs": n,
           "chunk_size": chunk, "n_chunks": -(-S // chunk), "wall_s": wall,
           "series_per_s": S / wall, "converged_pct": 100.0 * conv / S,
           "arma_lm_fit_launches": launches[0],
           "arma_ne_launches": launches[1],
           "arma_css_launches": launches[2],
           "vs_route": agree, "route_arma_ne_launches": route_launches,
           "refine_bitwise_fit": refine_is_fit,
           "methods_ms": methods_ms,
           "methods_arma_css_launches": methods_launches[0],
           "methods_arma_ne_launches": methods_launches[1],
           "methods_ll_vs_f64_within_1e-4": ll_close,
           "methods_sane_lanes": int(sane.sum()),
           "methods_grad_xreg_zero": bool((grad[:, 5:] == 0).all()),
           "ref_lanes": k, "ref_cpu_f64_s": r["seconds"],
           "ref_waited_s": waited, "ref_both_converged": int(both.sum()),
           "ref_neg_ll_agree_share": ll_share,
           "ref_median_rel_neg_ll": float(np.median(rel[both]))
           if both.any() else None,
           "resilient_s": res_s, "resilient_statuses": rout.counts(),
           "resilient_attempts": {int(a): int(c) for a, c in zip(
               *np.unique(rout.attempts, return_counts=True))},
           "resilient_arma_lm_fit_launches": res_launches[0],
           "resilient_arma_ne_launches": res_launches[1],
           "resilient_arma_ne_widths": res_widths,
           "resilient_stats_launches": {
               "lm_fit": st["lm_fit_launches"],
               "lm_fit_by_stage": st["lm_fit_launches_by_stage"],
               "ne": st["ne_launches"],
               "ne_by_stage": st["ne_launches_by_stage"]},
           "skipped_is_unfittable": bool(np.array_equal(
               np.flatnonzero(skipped), skipped_rows)),
           "health_bitwise_cpu": _bitwise_equal(rout.health, cpu_health),
           "ok_lanes": int(ok.sum()),
           "ok_bitwise_plain": _bitwise_equal(
               rmodel.coefficients.cpu().numpy()[ok],
               plain.coefficients.cpu().numpy()[ok])}
    emit(row)
    check(launches[0] == row["n_chunks"] and launches[1] == 0,
          f"arimax_path launched arma_lm_fit {launches[0]} times (one per "
          f"chunk: {row['n_chunks']}) and arma_ne {launches[1]} (0)")
    check(refine_is_fit,
          "arimax_path: the first chunk's refine is not the LM-fit launch "
          "on the adjusted series")
    check(methods_launches == (1, 1) and row["methods_grad_xreg_zero"]
          and ll_close >= 0.99,
          f"arimax_path methods: launches (arma_css, arma_ne) "
          f"{methods_launches}, expected (1, 1); CSS log likelihood within "
          f"1e-4 of float64 on {ll_close:.3f} of {int(sane.sum())} "
          f"stationary, invertible lanes (floor 0.99)")
    check(agree["n_iter_equal"] >= ARX_ROUTE_SHARE[0]
          and agree["fun_within_1e-5"] >= ARX_ROUTE_SHARE[1],
          f"arimax_path: the LM-fit kernel vs the route: {agree} (floors "
          f"{ARX_ROUTE_SHARE})")
    check(ll_share >= ARX_LL_FLOOR,
          f"arimax_path: only {ll_share:.3f} of {int(both.sum())} lanes "
          f"converged in both have a float64 CSS neg-LL at the card's "
          f"parameters within {ARX_LL_RTOL:g} of the float64 fit's (floor "
          f"{ARX_LL_FLOOR})")
    check(res_launches == (st["lm_fit_launches"], st["ne_launches"]),
          f"arimax_path resilient: launches {res_launches}, the stages "
          f"counted {(st['lm_fit_launches'], st['ne_launches'])}")
    check(row["skipped_is_unfittable"] and row["health_bitwise_cpu"],
          "arimax_path resilient: skipped lanes are not the unfittable "
          "rows, or health codes differ from the CPU's")
    check(row["ok_lanes"] > 0 and row["ok_bitwise_plain"],
          "arimax_path resilient: OK lanes differ from the plain fit")
    return row


def _exact_launches_per_eval(part, dev):
    """Device operations (kernels, copies, fills) one value-and-gradient
    evaluation of the exact objective puts on the card at ``part``'s lane
    count (``torch.profiler``: the runtime calls that do), and the
    host-side operator count; None where the profiler shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops.optimize import value_and_grad_of
    from spark_timeseries_tpu_torch.statespace.convert import \
        arma_concentrated_neg_ll

    diffed = part[:, 1:] - part[:, :-1]
    x = arima.fit(2, 1, 2, part, warn=False, device=dev).coefficients
    vag, _ = value_and_grad_of(
        lambda xx, yy: arma_concentrated_neg_ll(xx, yy, 2, 2, 1), diffed)
    vag(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vag(x)
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    # by the runtime calls that put work on the card (:func:`_profile_ops`)
    kernels = sum(1 for e in evs if _ENQUEUE.match(e.name()))
    ops = sum(1 for e in evs
              if e.device_type() != torch.autograd.DeviceType.CUDA
              and e.name().startswith("aten::"))
    return (kernels or None), ops


def phase_exact_path(panel, dev, ref, lanes=EXACT_LANES):
    """``arima.fit(2, 1, 2, chunk, objective="exact")`` on the north-star
    panel's first chunk: the CSS fit (one LM-fit launch), then the BFGS
    refine on the Kalman likelihood; seconds, iterations, calls, kernels
    a value-and-gradient evaluation, peak memory; every finite lane's
    exact log likelihood at least its CSS start's; 256 lanes against the
    float64 CPU exact fit; ``log_likelihood_exact`` against float64."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    part = torch.from_numpy(panel[:lanes]).to(dev)
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    st = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    exact = arima.fit(2, 1, 2, part, objective="exact", warn=False,
                      device=dev, stats=st)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = (arma_ne.fit_css_lm.launches,
                arma_ne.normal_equations.launches)
    css = arima.fit(2, 1, 2, part, warn=False, device=dev)
    ll_css = css.log_likelihood_exact(part)
    ll_ex = -exact.diagnostics.fun
    fin = torch.isfinite(ll_ex) & torch.isfinite(ll_css)
    monotone = float((ll_ex[fin] >= ll_css[fin]).double().mean())
    n_iter = exact.diagnostics.n_iter.cpu().numpy()
    # the float64 CPU exact fit of the first lanes, by objective
    pool, pending = ref
    t1 = time.perf_counter()
    r = pending["exact"].get(timeout=900)
    waited = time.perf_counter() - t1
    k = EXACT_REF_LANES
    v64 = torch.from_numpy(panel[:k].astype(np.float64))
    card64 = -arima.ARIMAModel(
        2, 1, 2, exact.coefficients[:k].double().cpu()
    ).log_likelihood_exact(v64).numpy()
    both = np.isfinite(card64) & np.isfinite(r["fun"])
    rel = np.abs(card64 - r["fun"]) / np.abs(r["fun"])
    ref_share = float(np.mean(rel[both] <= EXACT_LL_RTOL)) if both.any() \
        else 0.0
    # log_likelihood_exact on the card against float64 at its parameters
    kc = EXACT_CARD_LANES
    sub = arima.ARIMAModel(2, 1, 2, exact.coefficients[:kc])
    t2 = time.perf_counter()
    ll_card = sub.log_likelihood_exact(part[:kc])
    torch.cuda.synchronize()
    ll_ms = (time.perf_counter() - t2) * 1e3
    sub64 = arima.ARIMAModel(2, 1, 2, sub.coefficients.double().cpu())
    ll64 = sub64.log_likelihood_exact(
        torch.from_numpy(panel[:kc].astype(np.float64)))
    sane = torch.from_numpy(sub64.is_stationary() & sub64.is_invertible())
    close = torch.isclose(ll_card.double().cpu(), ll64, rtol=EXACT_CARD_RTOL,
                          atol=0.0)
    card_share = float(close[sane].double().mean()) if sane.any() else 0.0
    kernels, ops = _exact_launches_per_eval(part, dev)
    row = {"phase": "exact_path", "lanes": lanes, "n_obs": panel.shape[1],
           "seconds": seconds, "series_per_s": lanes / seconds,
           "bfgs_iterations_max": int(n_iter.max()),
           "bfgs_iterations_median": float(np.median(n_iter)),
           "exact_calls": st["exact_calls"],
           "bfgs_reported_apart_lanes": st["exact_reported_apart"],
           "kernels_per_evaluation": kernels,
           "host_ops_per_evaluation": ops,
           "peak_gib": peak / 2**30,
           "allocated_before_gib": before / 2**30,
           "arma_lm_fit_launches": launches[0],
           "arma_ne_launches": launches[1],
           "converged_pct": float(100.0 * exact.diagnostics.converged
                                  .double().mean()),
           "finite_lanes": int(fin.sum()), "monotone_share": monotone,
           "median_ll_gain": float((ll_ex - ll_css)[fin].double().median()),
           "ref_lanes": k, "ref_cpu_f64_s": r["seconds"],
           "ref_waited_s": waited, "ref_both_finite": int(both.sum()),
           "ref_neg_ll_agree_share": ref_share,
           "ref_median_rel_neg_ll": float(np.median(rel[both]))
           if both.any() else None,
           "ll_exact_lanes": kc, "ll_exact_ms": ll_ms,
           "ll_exact_sane_lanes": int(sane.sum()),
           "ll_exact_within_share": card_share}
    emit(row)
    check(launches[0] == 1,
          f"exact_path launched arma_lm_fit {launches[0]} times (1: the "
          f"CSS stage)")
    check(monotone == 1.0,
          f"exact_path: the exact log likelihood is below the CSS fit's on "
          f"{1.0 - monotone:.4f} of {int(fin.sum())} finite lanes")
    check(ref_share >= EXACT_LL_FLOOR,
          f"exact_path: only {ref_share:.3f} of {int(both.sum())} lanes "
          f"have a float64 exact neg-LL at the card's parameters within "
          f"{EXACT_LL_RTOL:g} of the float64 CPU exact fit's (floor "
          f"{EXACT_LL_FLOOR})")
    check(card_share >= EXACT_CARD_FLOOR,
          f"exact_path: log_likelihood_exact on the card within "
          f"{EXACT_CARD_RTOL:g} of float64 on {card_share:.4f} of "
          f"{int(sane.sum())} stationary, invertible lanes (floor "
          f"{EXACT_CARD_FLOOR})")
    return row


# -- slice 11: the series-major one-pass kernels ---------------------------

NE_ROWS_WIDTHS = (1024, 4096, 16384)   # while no path's widths are known
NE_ROWS_REPS = 10          # launches a turn; two turns each version


def width_quantiles(hists):
    """The median and 90th-percentile launch widths (power-of-two
    buckets) over launch-width histograms; None without launches."""
    counts = {}
    for h in hists:
        for b, n in h.items():
            counts[int(b)] = counts.get(int(b), 0) + n
    total = sum(counts.values())
    if not total:
        return None
    out, cum = [], 0
    for b in sorted(counts):
        cum += counts[b]
        while len(out) < 2 and cum >= (0.5, 0.9)[len(out)] * total:
            out.append(b)
    return tuple(out)


def _in_turns(old, new, reps):
    """CUDA-event medians of ``old()`` and ``new()`` over two turns each,
    in the order old, new, new, old."""
    t_old = _event_times(old, reps)
    t_new = _event_times(new, reps) + _event_times(new, reps)
    t_old += _event_times(old, reps)
    return float(np.median(t_old)), float(np.median(t_new))


# the runtime calls that put work on the card: kernel launches, copies,
# fills, graph launches
_ENQUEUE = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")


def _profile_ops(fn):
    """One ``fn()`` under ``torch.profiler`` (after one call outside it):
    the names of the runtime calls in it that put work on the card
    (kernel launches, copies, fills; CUPTI's callbacks on the host) and
    of the device records (kernels, copies, fills).

    Count the first, not the second: once a process has gone ~45 s
    without a profiler session, the profiler receives the device records
    of only some launches, or none, for the rest of the process, while
    every launch's runtime record still arrives (PERF.md §6)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    return ([e.name() for e in evs if _ENQUEUE.match(e.name())],
            [e.name() for e in evs
             if e.device_type() == torch.autograd.DeviceType.CUDA])


def _cuda_ops(fn):
    """Device operations (kernels, copies, fills) one ``fn()`` puts on
    the card: its runtime calls that do (:func:`_profile_ops`)."""
    return _profile_ops(fn)[0]


def _device_ms(fn, reps: int):
    """Median device duration of the one kernel ``fn()`` launches, over
    ``reps`` calls (``torch.profiler``'s CUDA events): the kernel's own
    time, without the host's launch in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return float(np.median(durs)) / 1e3 if durs else None


def _bits_equal(got, want) -> bool:
    import torch

    return all(torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
               for a, b in zip(got, want))


def phase_ne_rows_timing(panel, seed, dev, ne_hists, css_hists):
    """The series-major one-pass kernels against the time-major ones they
    replaced, at (2,1,2)+c on the main path's differenced chunk (n_obs
    127), dense and ragged, at S = 131072 and at the median and
    90th-percentile launch widths of the paths' histograms: bit for bit
    on every lane; CUDA-event medians in turns of each kernel alone and
    of each call (``normal_equations``, ``css_neg_ll_value_and_grad``,
    ``css_cost``) new against old; the bounds; the device operations a
    call runs (``torch.profiler``)."""
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    name, (p, q, icpt), y, params, _ = ne_cases(panel, seed)[0]
    nv = ne_cases(panel, seed)[1][4]
    y_all = torch.from_numpy(y).to(dev)
    prm_all = torch.from_numpy(params).to(dev)
    nv_all = torch.from_numpy(nv).to(dev)
    S_max, n_obs = y.shape
    ne_q, css_q = width_quantiles(ne_hists), width_quantiles(css_hists)
    picked = [w for qs in (ne_q, css_q) if qs for w in qs]
    widths = sorted({S_max} | {min(w, S_max) for w in
                               (picked or NE_ROWS_WIDTHS)})
    rows, all_bitwise = [], True
    for S in widths:
        for ragged in (False, True):
            yy, prm = y_all[:S], prm_all[:S]
            v = nv_all[:S] if ragged else None
            y_t, prm_t = yy.T.contiguous(), prm.T.contiguous()
            new = arma_ne.normal_equations(prm, yy, p, q, icpt, n_valid=v)
            old = arma_ne.normal_equations_time_major(prm, yy, p, q, icpt,
                                                      n_valid=v)
            css_new = arma_ne.css_cost(prm, yy, p, q, icpt, n_valid=v)
            css_old = arma_ne.css_cost_time_major(prm, yy, p, q, icpt,
                                                  n_valid=v)
            torch.cuda.synchronize()
            bitwise = {"normal_equations": _bits_equal(new, old),
                       "css_cost": _bits_equal((css_new,), (css_old,))}
            all_bitwise &= all(bitwise.values())
            pairs = {
                "ne_kernel": (
                    lambda: arma_ne._launch(prm_t, y_t, v, p, q, icpt),
                    lambda: arma_ne._ne_rows(prm, yy, v, None, p, q, icpt)),
                "normal_equations": (
                    lambda: arma_ne.normal_equations_time_major(
                        prm, yy, p, q, icpt, n_valid=v),
                    lambda: arma_ne.normal_equations(prm, yy, p, q, icpt,
                                                     n_valid=v)),
                "css_neg_ll_value_and_grad": (
                    lambda: arma_ne._css_neg_ll(
                        arma_ne.normal_equations_time_major, prm, yy, p, q,
                        icpt, v),
                    lambda: arma_ne.css_neg_ll_value_and_grad(
                        prm, yy, p, q, icpt, n_valid=v)),
                "css_kernel": (
                    lambda: arma_ne._css_launch(prm_t, y_t, v, p, q, icpt),
                    lambda: arma_ne._css_rows(prm, yy, v, p, q, icpt)),
                "css_cost": (
                    lambda: arma_ne.css_cost_time_major(prm, yy, p, q, icpt,
                                                        n_valid=v),
                    lambda: arma_ne.css_cost(prm, yy, p, q, icpt,
                                             n_valid=v))}
            ms = {}
            for key, (f_old, f_new) in pairs.items():
                t_old, t_new = _in_turns(f_old, f_new, NE_ROWS_REPS)
                ms[key] = {"old": t_old, "new": t_new}
                if key.endswith("_kernel"):
                    # the kernel's own time, without its host launch
                    ms[key]["old_device"] = _device_ms(f_old,
                                                       2 * NE_ROWS_REPS)
                    ms[key]["new_device"] = _device_ms(f_new,
                                                       2 * NE_ROWS_REPS)
            ne_b = ne_bound_s(S, n_obs, p, q, icpt, ragged)
            ne_b_old = ne_bound_s(S, n_obs, p, q, icpt, ragged, packed=True)
            css_b = css_bound_s(S, n_obs, p, q, icpt)
            css_b_s = css_b[0] if not ragged else max(
                (css_b[2] + 4 * S) / PEAK_BYTES_S,
                css_b[3] / PEAK_FP32_FLOPS)
            rows.append({
                "S": S, "ragged": ragged, "bitwise": bitwise, "ms": ms,
                "ne_tile": arma_ne.rows_tile(S, n_obs, p, q, icpt, False,
                                             dev)._asdict(),
                "css_tile": arma_ne.rows_tile(S, n_obs, p, q, icpt, True,
                                              dev)._asdict(),
                "ne_bound_ms": ne_b[0] * 1e3, "ne_bound_by": ne_b[1],
                "ne_time_major_bound_ms": ne_b_old[0] * 1e3,
                "ne_share_of_bound": ne_b[0] * 1e3 / ms["ne_kernel"]["new"],
                "ne_time_major_share_of_bound":
                    ne_b_old[0] * 1e3 / ms["ne_kernel"]["old"],
                "css_bound_ms": css_b_s * 1e3,
                "css_share_of_bound": css_b_s * 1e3 / ms["css_kernel"]["new"],
                "css_time_major_share_of_bound":
                    css_b_s * 1e3 / ms["css_kernel"]["old"]})
    # the device operations of one call at the full width, old and new
    yy, prm = y_all, prm_all
    calls = {
        "normal_equations": {
            "old": lambda: arma_ne.normal_equations_time_major(
                prm, yy, p, q, icpt),
            "new": lambda: arma_ne.normal_equations(prm, yy, p, q, icpt)},
        "css_cost": {
            "old": lambda: arma_ne.css_cost_time_major(prm, yy, p, q, icpt),
            "new": lambda: arma_ne.css_cost(prm, yy, p, q, icpt)},
        "css_neg_ll_value_and_grad": {
            "old": lambda: arma_ne._css_neg_ll(
                arma_ne.normal_equations_time_major, prm, yy, p, q, icpt,
                None),
            "new": lambda: arma_ne.css_neg_ll_value_and_grad(
                prm, yy, p, q, icpt)}}
    prof = {k: {v: _profile_ops(f) for v, f in d.items()}
            for k, d in calls.items()}
    ops = {k: {v: e[0] for v, e in d.items()} for k, d in prof.items()}
    row = {"phase": "ne_rows_timing", "case": name, "n_obs": n_obs,
           "widths": widths, "ne_width_quantiles": ne_q,
           "css_width_quantiles": css_q, "reps": 2 * NE_ROWS_REPS,
           "rows": rows,
           "device_ops_per_call": {k: {v: len(n) for v, n in d.items()}
                                   for k, d in ops.items()},
           "device_op_names": ops,
           "device_records_received": {
               k: {v: e[1] for v, e in d.items()} for k, d in prof.items()}}
    emit(row)
    check(all_bitwise, "ne_rows_timing: a series-major kernel's result is "
                       "not the time-major kernel's bit for bit")
    for key in ("normal_equations", "css_cost"):
        n_ops = len(ops[key]["new"])
        check(n_ops == 1, f"ne_rows_timing: one {key} call ran {n_ops} "
                          f"device operations, not 1: {ops[key]['new']}")
    return row


# -- slice 12: online serving ----------------------------------------------

SERV_SERIES = 131072       # one chunk of the north-star panel
SERV_HIST = 64             # history columns; the last 64 are live ticks
SERV_BENCH_SERIES = 1024   # bench.py's BENCH_SERVING_SERIES default
SERV_HORIZON = 24
SERV_REF_LANES = 256       # lanes of the float64 CPU session
SERV_RTOL = 1e-3           # of the lane's largest entry
SERV_SHARE = 0.99
SERV_HW_HIST = 104         # Holt-Winters history columns; 16 ticks
SERV_QUALITY_TICKS = 48


def _lane_share(got, want, rtol):
    """Share of lanes (rows) whose entries are within ``rtol`` of the
    lane's largest finite reference entry, NaN where the reference is
    NaN and nowhere else."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    same_nan = (np.isnan(got) == np.isnan(want)).all(axis=1)
    fin = np.where(np.isfinite(want), np.abs(want), 0.0)
    big = fin.max(axis=1, initial=0.0)
    diff = np.where(np.isnan(want) & np.isnan(got), 0.0, np.abs(got - want))
    ok = same_nan & (np.nan_to_num(diff, nan=np.inf)
                     <= rtol * big[:, None]).all(axis=1)
    return ok


def _serving_ticks(sess, live, ref_lanes):
    """Tick ``sess`` through the columns of ``live``: each tick's
    ``serving.update`` span time (the session's latency window: the
    tick and its TickResult's copy to the host), the call's host wall,
    and the first ``ref_lanes`` lanes' v, F and statuses."""
    k = live.shape[1]
    walls, vs, fs, sts = [], [], [], []
    out = None
    for t in range(k):
        t0 = time.perf_counter()
        out = sess.update(live[:, t])
        walls.append((time.perf_counter() - t0) * 1e3)
        vs.append(out.innovations[:ref_lanes])
        fs.append(out.variances[:ref_lanes])
        sts.append(out.status[:ref_lanes])
    span = [x * 1e3 for x in list(sess._tick_lat)[-k:]]
    return out, {"ticks": k,
                 "tick_p50_ms": float(np.percentile(span, 50)),
                 "tick_p95_ms": float(np.percentile(span, 95)),
                 "tick_max_ms": float(np.max(span)),
                 "call_p50_ms": float(np.percentile(walls, 50)),
                 "call_p95_ms": float(np.percentile(walls, 95))}, \
        (np.stack(vs, 1), np.stack(fs, 1), np.stack(sts, 1))


def _tick_ops(sess, tick):
    """Device operations (``torch.profiler``) of one tick of ``sess``,
    its inputs' copies to the card and its TickResult's copy back
    included, on the session's buffers (the tick is pure: the session
    does not move)."""
    n = sess.n_series
    y = np.full((sess._bucket,), np.nan, sess._dtype)
    y[:n] = tick
    off = np.zeros((sess._bucket,), sess._dtype)

    def one():
        _, h2, _, v, f, ll, anom = sess._device_tick(y, off)
        sess._tick_result(v, f, ll, h2, anom)

    return _cuda_ops(one)


def _serving_ref(model64, hist64, live64, quality=None, horizon=0):
    """The port's float64 CPU session over the reference lanes: per-tick
    v, F, statuses, the forecast, the quality state."""
    from spark_timeseries_tpu_torch.statespace import serving

    sess = serving.ServingSession.start(model64, hist64, device="cpu",
                                        quality=quality)
    _, _, ticks = _serving_ticks(sess, live64, live64.shape[0])
    fc = sess.forecast(horizon) if horizon else None
    return ticks, fc, sess


def phase_serving_path(panel, hw_panel, dev, n_series=SERV_SERIES,
                       bench_series=SERV_BENCH_SERIES):
    """The online serving tier on the card, float32: an ARIMA(2,1,2)+c
    session over the north-star panel's first chunk (fit on its first 64
    columns, the LM-fit kernel once; 64 live ticks: p50 / p95 ms, device
    operations a tick, ``state_bytes``, ``update_batch`` bitwise the
    single updates, ``forecast(24)``, against the port's float64 CPU
    session on 256 lanes); the same tick at bench width (1024 series);
    an additive Holt-Winters session (period 12, the box-fit kernel
    once, 16 ticks); ``heal()`` of 8 poisoned lanes (the refit chain's
    LM-fit launches, the untouched lanes bit for bit); a session with
    the quality plane (48 ticks, online sMAPE / MASE against float64);
    checkpoint and restore on the card, the next tick bitwise."""
    import tempfile

    import torch

    from spark_timeseries_tpu_torch.models import arima, holt_winters
    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse
    from spark_timeseries_tpu_torch.statespace import health, serving
    from spark_timeseries_tpu_torch.utils import metrics, resilience

    def counts():
        return {"arma_lm_fit": arma_ne.fit_css_lm.launches,
                "arma_ne": arma_ne.normal_equations.launches,
                "arma_css": arma_ne.css_cost.launches,
                "hw_box_fit": hw_sse.box_fit.launches,
                "hw_sse": hw_sse.value_and_grad.launches}

    for w in (arma_ne.fit_css_lm, arma_ne.normal_equations,
              arma_ne.css_cost, hw_sse.box_fit, hw_sse.value_and_grad):
        w.launches = 0
    k_ref = SERV_REF_LANES
    hist = np.ascontiguousarray(panel[:n_series, :SERV_HIST])
    live = np.ascontiguousarray(panel[:n_series, SERV_HIST:])
    row = {"phase": "serving_path", "n_series": n_series,
           "history": SERV_HIST, "live_ticks": live.shape[1]}

    # -- ARIMA(2,1,2)+c at 131072 series
    t0 = time.perf_counter()
    model = arima.fit(2, 1, 2, hist, warn=False, device=dev)
    torch.cuda.synchronize()
    row["fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess = serving.ServingSession.start(model, hist, device=dev)
    torch.cuda.synchronize()
    row["start_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.warmup()
    row["warmup_ms"] = (time.perf_counter() - t0) * 1e3
    last, lat, card_ticks = _serving_ticks(sess, live, k_ref)
    row["arima"] = dict(lat, state_bytes=sess.state_bytes,
                        state_dim=sess.meta.m, bucket=sess._bucket,
                        device_ops_per_tick=len(_tick_ops(sess, live[:, -1])),
                        health=sess.health_counts())
    fc_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        fc = sess.forecast(SERV_HORIZON)
        fc_ms.append((time.perf_counter() - t0) * 1e3)
    row["arima"]["forecast_ms_first"], row["arima"]["forecast_ms"] = fc_ms
    check(fc.shape == (n_series, SERV_HORIZON),
          f"serving_path: forecast shape {fc.shape}")
    # update_batch of the same ticks on a second session started the same
    # way: bitwise the single updates
    twin = serving.ServingSession.start(model, hist, device=dev)
    t0 = time.perf_counter()
    b_last = twin.update_batch(live)
    row["arima"]["update_batch_ms"] = (time.perf_counter() - t0) * 1e3
    batch_bitwise = all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                        for a, b in zip(b_last, last)) and _bits_equal(
        [t.float() for t in twin._state], [t.float() for t in sess._state])
    row["arima"]["update_batch_bitwise"] = batch_bitwise
    del twin
    # against the port's float64 CPU session on the first lanes
    model64 = arima.ARIMAModel(2, 1, 2, model.coefficients[:k_ref].double()
                               .cpu(), True)
    ref_ticks, ref_fc, _ = _serving_ref(
        model64, hist[:k_ref].astype(np.float64),
        live[:k_ref].astype(np.float64), horizon=SERV_HORIZON)
    ok = _lane_share(card_ticks[0], ref_ticks[0], SERV_RTOL) \
        & _lane_share(card_ticks[1], ref_ticks[1], SERV_RTOL) \
        & _lane_share(fc[:k_ref], ref_fc, SERV_RTOL)
    status_eq = (card_ticks[2] == ref_ticks[2]).all(axis=1)
    # a fitted model that is not stationary and invertible gets a prior
    # covariance from a Lyapunov solve that is not positive definite, or
    # the 1e6-scaled diffuse one: float32 cannot carry either through the
    # first updates, so the floors hold on the other lanes (as
    # exact_path's), and the shares over every lane are reported
    sane = np.asarray(model64.is_stationary() & model64.is_invertible())
    row["arima"].update(ref_lanes=k_ref, ref_sane_lanes=int(sane.sum()),
                        ref_share=float(ok[sane].mean()),
                        ref_status_share=float(status_eq[sane].mean()),
                        ref_share_all=float(ok.mean()),
                        ref_status_share_all=float(status_eq.mean()))

    # -- the same tick at bench width
    small = arima.ARIMAModel(2, 1, 2, model.coefficients[:bench_series],
                             True)
    bench = serving.ServingSession.start(small, hist[:bench_series],
                                         device=dev)
    bench.warmup()
    _, lat_b, _ = _serving_ticks(bench, live[:bench_series], 0)
    row["bench_width"] = dict(
        lat_b, n_series=bench_series, state_bytes=bench.state_bytes,
        device_ops_per_tick=len(_tick_ops(bench,
                                          live[:bench_series, -1])))
    del bench

    # -- additive Holt-Winters, period 12
    hw_hist = np.ascontiguousarray(hw_panel[:n_series, :SERV_HW_HIST])
    hw_live = np.ascontiguousarray(hw_panel[:n_series, SERV_HW_HIST:])
    t0 = time.perf_counter()
    hw_model = holt_winters.fit(hw_hist, HW_PERIOD, "additive", device=dev)
    torch.cuda.synchronize()
    hw_fit_s = time.perf_counter() - t0
    hw_sess = serving.ServingSession.start(hw_model, hw_hist, device=dev)
    hw_sess.warmup()
    _, lat_h, hw_ticks = _serving_ticks(hw_sess, hw_live, k_ref)
    hw_fc = hw_sess.forecast(SERV_HORIZON)
    hw64 = holt_winters.HoltWintersModel(
        "additive", HW_PERIOD,
        *(getattr(hw_model, f)[:k_ref].double().cpu()
          for f in ("alpha", "beta", "gamma")))
    hw_ref, hw_ref_fc, _ = _serving_ref(
        hw64, hw_hist[:k_ref].astype(np.float64),
        hw_live[:k_ref].astype(np.float64), horizon=SERV_HORIZON)
    hw_ok = _lane_share(hw_ticks[0], hw_ref[0], SERV_RTOL) \
        & _lane_share(hw_ticks[1], hw_ref[1], SERV_RTOL) \
        & _lane_share(hw_fc[:k_ref], hw_ref_fc, SERV_RTOL)
    hw_status_eq = (hw_ticks[2] == hw_ref[2]).all(axis=1)
    row["holt_winters"] = dict(
        lat_h, fit_s=hw_fit_s, history=SERV_HW_HIST,
        state_bytes=hw_sess.state_bytes, state_dim=hw_sess.meta.m,
        covariance_mib=hw_sess._state.P.numel() * 4 / 2**20,
        device_ops_per_tick=len(_tick_ops(hw_sess, hw_live[:, -1])),
        health=hw_sess.health_counts(), ref_lanes=k_ref,
        ref_share=float(hw_ok.mean()),
        ref_status_share=float(hw_status_eq.mean()))
    del hw_sess

    # -- heal: 8 poisoned lanes of a private-registry session
    reg = metrics.MetricsRegistry()
    hs = serving.ServingSession.start(model, hist, device=dev, registry=reg)
    stride = n_series // 8
    with resilience.fault_injection("state_poison", lane_stride=stride):
        hs.update(live[:, 0])
    hs.update(live[:, 1])
    poisoned = np.arange(n_series)[::stride]
    # the poisoned lanes, and any lane the monitor quarantined on its own
    diverged = np.flatnonzero(hs.lane_status == health.LANE_DIVERGED)
    quarantined = int(diverged.size)
    before_state = [t.clone() for t in hs._state]
    before_ssm = [t.clone() for t in hs._ssm]
    c0 = counts()
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = hs.heal(stats=st)
    torch.cuda.synchronize()
    heal_ms = (time.perf_counter() - t0) * 1e3
    c1 = counts()
    heal_launches = {k: c1[k] - c0[k] for k in c0}
    grid = st.get("lm_fit_launches_by_stage", {}).get("auto_order", 0)
    keep = torch.ones(hs._bucket, dtype=torch.bool, device=dev)
    keep[torch.from_numpy(diverged).to(dev)] = False
    untouched = _bits_equal([t[keep].float() for t in hs._state],
                            [t[keep].float() for t in before_state]) \
        and _bits_equal([t[keep].float() for t in hs._ssm],
                        [t[keep].float() for t in before_ssm])
    still = int(np.sum(hs.lane_status[poisoned] == health.LANE_DIVERGED))
    row["heal"] = {"poisoned": int(poisoned.size),
                   "quarantined": quarantined,
                   "quarantined_unpoisoned": int(np.setdiff1d(
                       diverged, poisoned).size), "report": rep,
                   "ms": heal_ms, "refit_stats": st,
                   "launches": heal_launches, "grid_launches": grid,
                   "still_diverged": still, "untouched_bitwise": untouched,
                   "counters": {k: v for k, v in
                                reg.snapshot()["counters"].items()
                                if k.startswith("serving.")}}
    del hs, before_state, before_ssm

    # -- the quality plane: 48 ticks, online accuracy against float64
    qs = serving.ServingSession.start(model, hist, device=dev,
                                      quality=serving.QualityPolicy())
    qs.warmup()
    q_live = live[:, :SERV_QUALITY_TICKS]
    _, lat_q, _ = _serving_ticks(qs, q_live, 0)
    _, _, q_ref = _serving_ref(model64, hist[:k_ref].astype(np.float64),
                               q_live[:k_ref].astype(np.float64),
                               quality=serving.QualityPolicy())
    q_host = qs._quality_host()
    q_ref_host = q_ref._quality_host()
    q_ok = _lane_share(q_host["ew_smape"][:k_ref, None],
                       q_ref_host["ew_smape"][:, None], SERV_RTOL) \
        & _lane_share(q_host["ew_mase"][:k_ref, None],
                      q_ref_host["ew_mase"][:, None], SERV_RTOL)
    row["quality"] = dict(lat_q, summary=qs.quality_summary(),
                          drift_alarms=int(qs._drift_alarms),
                          state_bytes=qs.state_bytes,
                          device_ops_per_tick=len(_tick_ops(qs,
                                                            q_live[:, -1])),
                          ref_lanes=k_ref, ref_share=float(q_ok[sane].mean()),
                          ref_share_all=float(q_ok.mean()))
    del qs

    # -- checkpoint and restore on the card: the next tick bitwise
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        path = os.path.join(d, "serving")
        t0 = time.perf_counter()
        sess.checkpoint(path)
        ck_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = serving.ServingSession.restore(path, device=dev)
        torch.cuda.synchronize()
        rs_s = time.perf_counter() - t0
        ck_mib = (os.path.getsize(path + ".npz") + os.path.getsize(
            path + ".tree.json")) / 2**20
    nxt = live[:, -1] * np.float32(0.9)
    a, b = sess.update(nxt), back.update(nxt)
    restore_bitwise = all(np.array_equal(x.view(np.uint8),
                                         y.view(np.uint8))
                          for x, y in zip(a, b)) and _bits_equal(
        [t.float() for t in back._state], [t.float() for t in sess._state])
    row["checkpoint"] = {"checkpoint_s": ck_s, "restore_s": rs_s,
                         "mib": ck_mib, "next_tick_bitwise": restore_bitwise}
    del sess, back
    launches = counts()
    row["launches"] = launches
    row["arma_lm_fit_launches"] = launches["arma_lm_fit"] - grid
    row["arma_lm_fit_grid_launches"] = grid
    emit(row)
    check(launches["hw_box_fit"] == 1,
          f"serving_path launched hw_box_fit {launches['hw_box_fit']} times "
          f"(1: the Holt-Winters fit)")
    check(launches["arma_lm_fit"] == 1 + st.get("lm_fit_launches", -1),
          f"serving_path: arma_lm_fit launches {launches['arma_lm_fit']} != "
          f"1 (the fit) + the heal's refit chain's "
          f"{st.get('lm_fit_launches')}")
    check(heal_launches["arma_lm_fit"] == st.get("lm_fit_launches")
          and heal_launches["arma_lm_fit"] >= 1,
          f"serving_path: the heal launched arma_lm_fit "
          f"{heal_launches['arma_lm_fit']} times, its refit chain counted "
          f"{st.get('lm_fit_launches')}")
    check(launches["arma_ne"] == 0 and launches["arma_css"] == 0
          and launches["hw_sse"] == 0,
          f"serving_path launched a one-pass kernel: {launches}")
    check(batch_bitwise, "serving_path: update_batch is not the 64 single "
                         "updates bit for bit")
    for name, r, lanes in (("arima", row["arima"], int(sane.sum())),
                           ("holt_winters", row["holt_winters"], k_ref)):
        check(r["ref_share"] >= SERV_SHARE,
              f"serving_path {name}: v, F and forecasts within "
              f"{SERV_RTOL:g} of the float64 CPU session on "
              f"{r['ref_share']:.4f} of {lanes} lanes (floor {SERV_SHARE})")
        check(r["ref_status_share"] >= SERV_SHARE,
              f"serving_path {name}: statuses equal the float64 CPU "
              f"session's on {r['ref_status_share']:.4f} of {lanes} lanes "
              f"(floor {SERV_SHARE})")
    check(np.isin(poisoned, diverged).all() and still == 0
          and rep["quarantined"] == quarantined
          and rep["healed"] >= poisoned.size,
          f"serving_path: heal restored {rep['healed']} of {quarantined} "
          f"quarantined lanes, {still} of the {poisoned.size} poisoned "
          f"ones still diverged")
    check(untouched, "serving_path: heal changed an untouched lane")
    check(row["quality"]["ref_share"] >= SERV_SHARE,
          f"serving_path quality: online sMAPE and MASE within "
          f"{SERV_RTOL:g} of float64 on {row['quality']['ref_share']:.4f} "
          f"of {int(sane.sum())} lanes (floor {SERV_SHARE})")
    check(restore_bitwise, "serving_path: the restored session's next tick "
                           "is not the original's bit for bit")
    return row


# ---------------------------------------------------------------------------
# slice 13: the long-series tier and rolling-origin backtesting
# ---------------------------------------------------------------------------

LONG_N_OBS = 1_000_000     # bench.py's long demo (BENCH_LONG_OBS default)
LONG_SEED = 11
LONG_PI1_TOL = 0.05        # test_fit_long_million_obs_end_to_end's check
LONG_STAGED_TOL = 1e-6     # tests/test_fused.py:185's fused-vs-staged bound
LONG_PLAIN_ITER = 2        # LM iterations of the kernel-vs-plain check
LM_SUM_U = 6e-8            # float32 unit roundoff (2⁻²⁴)
LONG_PLAIN_RTOL = 1e-3     # fun at 8192 steps: 2·n·u = 9.8e-4 (lm_plain_rtol)
LONG_PLAIN_SHARE = 0.95
LONG_PLAIN_LANES = 8       # lanes of the few-lane kernel-vs-plain checks
LONG_REF_OBS = 131_072     # the float64 CPU comparison's head of the series
LONG_REF_SEG = 8192        # 16 segments (the default would pick 4096)
LONG_REF_COEF_TOL = 1e-3   # float32 LM stops ~1e-3 from the f64 optimum
LONG_REF_FC_RTOL = 1e-3    # of max(1, |forecast|): the coefficients' gap
LONG_PIN_RTOL = 1e-7       # float64 origin recovery vs the sequential filter
LONG_HUGE_OBS = 100_000_000   # the tier's top scale (400 MB of float32)
ULTRA_SERIES = 8           # bench_suite.py:448-460's arima.fit_long config
ULTRA_OBS = 262_144
ULTRA_SEG = 16_384
ULTRA_SEED = 7
ULTRA_TOL = 0.05           # bench_suite.py's own agreement check
BT_SERIES = 16             # bench.py's backtest demo: 3 x 16 series
BT_OBS = 768
BT_BURN = 256
BT_WIDE = 43_690           # 3 x 43,690 = 131,070 series
BT_GRID = {"ar": [1, 2], "arima": [(1, 0, 1)], "ewma": True}
BT_HORIZONS = (1, 2, 4)
BT_SCHEDULE = dict(n_origins=128, stride=2, min_train=BT_OBS - 256)
BT_CHAMP_FLOOR = 0.95      # champions equal to the float64 CPU run's
BT_SCORE_RTOL = 1e-3       # champion scores vs float64 (CPU f32: ~8e-5)
BT_PIN_LANES = 256
BT_PIN_SCHEDULE = dict(n_origins=32, stride=8, min_train=BT_OBS - 256)
BT_PIN_RTOL = 1e-4         # of max(1, |forecast|): f32 log-depth vs loop
BT_LONG_SERIES = 2
BT_LONG_OBS = 524_288
BT_LONG_TRAIN = 500_000    # the fit window: backtest's default long_threshold


def long_series(n: int, seed: int, dev):
    """``bench.py``'s long demo series: ε ~ N(0, 1) from ``seed``, the MA
    part ``x_t = ε_t + 0.4 ε_{t-1}`` on the host, the AR part through
    the port's log-depth ``ops.scan_parallel.ar1_filter`` (c 0.1, φ 0.6)
    on ``dev``: a float32 ARMA(1,1) with π₁ = φ + θ = 1.0."""
    import torch

    from spark_timeseries_tpu_torch.ops.scan_parallel import ar1_filter

    rng = np.random.default_rng(seed)
    e = rng.standard_normal(n + 1).astype(np.float32)
    x = e[1:] + np.float32(0.4) * e[:-1]
    return ar1_filter(torch.from_numpy(x).to(dev), 0.1, 0.6).cpu().numpy()


def _long_ref_part(series: np.ndarray):
    """The float64 CPU run of the long-series comparison (in a spawned
    process): ``longseries.fit_long`` over the head of the series at
    ``LONG_REF_SEG``, its forecast off the recovered origin, and the
    forecast of the statespace filter run step by step over the whole
    differenced span."""
    import torch

    from spark_timeseries_tpu_torch import longseries
    from spark_timeseries_tpu_torch.statespace.convert import to_statespace
    from spark_timeseries_tpu_torch.statespace.health import (HealthPolicy,
                                                             initial_health)
    from spark_timeseries_tpu_torch.statespace.kalman import filter_panel
    from spark_timeseries_tpu_torch.statespace.serving import _forecast_impl
    from spark_timeseries_tpu_torch.statespace.ssm import (SSMeta,
                                                          initial_state)

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    y = series.astype(np.float64)
    lf = longseries.fit_long(y, (1, 0, 1), seg_len=LONG_REF_SEG, warn=False,
                             device="cpu")
    fc = lf.forecast(24)
    fit_s = time.perf_counter() - t0
    ssm, meta = to_statespace(lf.model)
    meta0 = SSMeta(meta.family, meta.mode, 0, meta.m)
    seq = filter_panel(ssm, initial_state(ssm, meta0),
                       torch.from_numpy(y[None]), meta0).state
    seq_fc = _forecast_impl(meta, 24, HealthPolicy().validate(), ssm, seq,
                            initial_health(seq),
                            torch.zeros((1, 24), dtype=torch.float64))[0]
    return {"coefficients": lf.coefficients.numpy(), "forecast": fc,
            "sequential_forecast": seq_fc.numpy(), "fit_s": fit_s,
            "seconds": time.perf_counter() - t0}


def start_long_ref(series: np.ndarray):
    """Start :func:`_long_ref_part` in a spawned process; returns ``(pool,
    pending)``."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, pool.apply_async(_long_ref_part, (series,))


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lm_counts():
    from spark_timeseries_tpu_torch.ops import arma_ne

    return {"arma_lm_fit": arma_ne.fit_css_lm.launches,
            "arma_ne": arma_ne.normal_equations.launches,
            "arma_css": arma_ne.css_cost.launches}


def _zero_lm_counts():
    from spark_timeseries_tpu_torch.ops import arma_ne

    for w in (arma_ne.fit_css_lm, arma_ne.normal_equations,
              arma_ne.css_cost):
        w.launches = 0


def _fused_bytes():
    from spark_timeseries_tpu_torch.utils import metrics

    return metrics.get_registry().snapshot()["counters"].get(
        "longseries.fused_bytes_d2h", 0)


def lm_plain_rtol(n_obs: int) -> float:
    """The bound on ``fun`` of the LM-fit kernel against the plain LM at
    ``n_obs`` steps: each side's float32 sum over the steps carries up to
    about ``n·u`` of relative rounding (u = ``LM_SUM_U``), so the two
    differ by up to twice that."""
    return 2.0 * n_obs * LM_SUM_U


def _fun_gap(got, want, rtol):
    """``fun``'s share of lanes within ``rtol`` relative (NaN matching
    NaN) and its largest relative gap (0 where both sides are equal or
    NaN, inf where only one side is NaN or infinite)."""
    import torch

    a, b = got[1].double(), want[1].double()
    within = torch.isclose(a, b, rtol=rtol, atol=0.0, equal_nan=True)
    rel = torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)), 0.0,
                      (a - b).abs() / b.abs())
    rel = torch.nan_to_num(rel, nan=float("inf"))
    return float(within.double().mean()), float(rel.max())


def _lm_plain_part(x0: np.ndarray, y: np.ndarray, p: int, q: int):
    """``fit_css_lm_plain`` on the CPU in float32 from the starts ``x0``
    for ``LONG_PLAIN_ITER`` iterations (in a spawned process: the step
    loop over a few long lanes is quicker on host cores than as
    launch-bound card operations); ``(outputs as arrays, seconds)``."""
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    out = arma_ne.fit_css_lm_plain(torch.from_numpy(x0), torch.from_numpy(y),
                                   p, q, 1, 1e-6, LONG_PLAIN_ITER)
    return tuple(o.numpy() for o in out), time.perf_counter() - t0


def start_lm_vs_plain(y: np.ndarray, p: int, q: int, dev, pool=None):
    """The LM-fit kernel on the lanes ``y (L, n)`` as the path gives them
    (float32), ARMA(p, q) with an intercept, from their Hannan-Rissanen
    starts, for ``LONG_PLAIN_ITER`` iterations on the card; the plain LM
    from the same starts on the same inputs on the CPU, in ``pool`` (a
    spawned pool) or here.  Returns a function that gives the row:
    ``fun`` within :func:`lm_plain_rtol` on a share of lanes, its largest
    relative gap, equal iteration counts, the largest ``|x - x_plain|``."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    yd = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(dev)
    x0 = arima.hannan_rissanen_init(p, q, yd, True)
    got = arma_ne.fit_css_lm(x0, yd, p, q, 1, tol=1e-6,
                             max_iter=LONG_PLAIN_ITER)
    got = tuple(t.cpu() for t in got)
    args = (x0.cpu().numpy(), yd.cpu().numpy(), p, q)
    pending = pool.apply_async(_lm_plain_part, args) if pool is not None \
        else None
    done = None if pool is not None else _lm_plain_part(*args)

    def finish():
        outs, secs = pending.get() if pending is not None else done
        want = tuple(torch.from_numpy(o) for o in outs)
        rtol = lm_plain_rtol(yd.shape[1])
        share, gap = _fun_gap(got, want, rtol)
        return {"lanes": int(yd.shape[0]), "n_obs": int(yd.shape[1]),
                "order": [p, q], "iterations": LONG_PLAIN_ITER,
                "plain_cpu_s": secs, "fun_rtol": rtol,
                "fun_within": share, "fun_max_rel_gap": gap,
                "n_iter_equal": float((got[3] == want[3]).double().mean()),
                "max_abs_x": _max_abs_x(got, want)}
    return finish


def check_lm_vs_plain(chk, r, where: str) -> None:
    chk(r["fun_within"] >= LONG_PLAIN_SHARE,
        f"{where}: arma_lm_fit vs the plain LM ({r['iterations']} "
        f"iterations, {r['lanes']} x {r['n_obs']} at ARMA{tuple(r['order'])})"
        f": fun within {r['fun_rtol']:g} on {r['fun_within']} of lanes "
        f"(floor {LONG_PLAIN_SHARE}; largest gap {r['fun_max_rel_gap']:g})")


def long_lm_vs_plain(panel: np.ndarray, dev):
    """The LM-fit kernel at the long path's shape (every segment of the
    10⁶ panel, ``(122, 8192)``): its CUDA-event ms (its launch as the
    fused path makes it, median of 3), the lanes' passes and the bound;
    then, from the same Hannan-Rissanen starts, the kernel against
    ``fit_css_lm_plain`` on the card, both at ``LONG_PLAIN_ITER``
    iterations (the plain LM is a step loop: 8191 steps a pass)."""
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    y = torch.from_numpy(panel).to(dev)
    x0 = arima.hannan_rissanen_init(1, 1, y, True)
    got = arma_ne.fit_css_lm(x0, y, 1, 1, 1, tol=1e-6, max_iter=50)
    ms = _event_ms(lambda: arma_ne.fit_css_lm(x0, y, 1, 1, 1, tol=1e-6,
                                              max_iter=50), 3)
    passes = (1 + got[3]).double()
    S, n = y.shape
    bound_s, bound_by, _, _ = lm_fit_bound_s(S, n, 1, 1, 1,
                                             int(passes.sum()))
    short = arma_ne.fit_css_lm(x0, y, 1, 1, 1, tol=1e-6,
                               max_iter=LONG_PLAIN_ITER)
    t0 = time.perf_counter()
    plain = arma_ne.fit_css_lm_plain(x0, y, 1, 1, 1, 1e-6, LONG_PLAIN_ITER)
    _sync(dev)
    plain_s = time.perf_counter() - t0
    fun_within, fun_gap = _fun_gap(short, plain, LONG_PLAIN_RTOL)
    return {"lanes": S, "n_obs": n, "lm_fit_ms": ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "lane_passes_mean": float(passes.mean()),
            "lane_passes_max": int(passes.max()),
            "plain_iterations": LONG_PLAIN_ITER, "plain_ms": plain_s * 1e3,
            "vs_plain_n_iter_equal": float((short[3] == plain[3])
                                           .double().mean()),
            "vs_plain_fun_rtol": LONG_PLAIN_RTOL,
            "vs_plain_fun_within": fun_within,
            "vs_plain_fun_max_rel_gap": fun_gap,
            "vs_plain_max_abs_x": _max_abs_x(short, plain)}


class _Checks:
    """Checks of a phase, held until its row is printed: ``chk(ok,
    what)`` records a failure, :meth:`raise_first` raises the first as
    :func:`check` does."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> None:
        if not ok:
            self.failed.append(what)

    def raise_first(self) -> None:
        for what in self.failed:
            check(False, what)


def phase_long_path(dev, n_obs=LONG_N_OBS, huge_obs=LONG_HUGE_OBS,
                    ultra=(ULTRA_SERIES, ULTRA_OBS, ULTRA_SEG)):
    """The long-series tier on the card, float32 (module docstring, 26)."""
    import collections

    import torch

    from spark_timeseries_tpu_torch import longseries
    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.longseries import api as ls_api
    from spark_timeseries_tpu_torch.longseries import split
    from spark_timeseries_tpu_torch.models import arima

    row = {"phase": "long_path"}
    chk = _Checks()
    t_phase = time.perf_counter()
    series = long_series(n_obs, LONG_SEED, dev)
    ref = start_long_ref(series[:LONG_REF_OBS])
    import multiprocessing
    plain_pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        # -- 10⁶ observations, the default (fused) path -------------------
        _zero_lm_counts()
        b0 = _fused_bytes()
        _sync(dev)
        t0 = time.perf_counter()
        lf = longseries.fit_long(series, order=(1, 0, 1), warn=False,
                                 device=dev)
        _sync(dev)
        fit_s = time.perf_counter() - t0
        launches = _lm_counts()
        d2h = _fused_bytes() - b0
        t0 = time.perf_counter()
        fc = lf.forecast(24)
        forecast_s = time.perf_counter() - t0
        coefs = lf.coefficients.cpu().numpy()
        pi1 = float(coefs[1])
        want_bytes = longseries.combine.expected_combine_acc_bytes(12)
        row["million"] = {
            "n_obs": n_obs, "n_segments": lf.plan.n_segments,
            "seg_len": lf.plan.seg_len, "fit_s": fit_s,
            "obs_per_s": lf.plan.n_used / fit_s,
            "forecast_s_incl_origin": forecast_s,
            "segments_weighted": lf.combined.n_weighted,
            "used_wls": lf.combined.used_wls, "pi1": pi1,
            "sigma2": float(lf.sigma2), "n_chunks": lf.stream_stats[
                "n_chunks"], "launches": launches,
            "fused_bytes_d2h": d2h, "expected_bytes": want_bytes,
            "forecast_finite": bool(np.isfinite(fc).all())}
        chk(abs(pi1 - 1.0) < LONG_PI1_TOL,
              f"long_path: π₁ = {pi1} at 10⁶ obs (want 1.0 ± {LONG_PI1_TOL})")
        chk(launches["arma_lm_fit"] == lf.stream_stats["n_chunks"]
              == lf.stream_stats["lm_fit_launches"],
              f"long_path: {launches['arma_lm_fit']} arma_lm_fit launches "
              f"for {lf.stream_stats['n_chunks']} segment chunks")
        chk(launches["arma_ne"] == 0 and launches["arma_css"] == 0,
              f"long_path launched a one-pass kernel: {launches}")
        chk(d2h == want_bytes,
              f"long_path: the fused combine copied {d2h} bytes to the "
              f"host, expected_combine_acc_bytes(12) = {want_bytes}")
        chk(fc.shape == (24,) and bool(np.isfinite(fc).all()),
              "long_path: forecast(24) is not 24 finite values")

        # -- staged against fused ------------------------------------------
        _zero_lm_counts()
        _sync(dev)
        t0 = time.perf_counter()
        lf_s = longseries.fit_long(series, order=(1, 0, 1), warn=False,
                                   fused=False, device=dev)
        _sync(dev)
        staged_s = time.perf_counter() - t0
        staged_launches = _lm_counts()
        panel = split.segment_panel(series, lf.plan)
        step = lf.stream_stats["chunk_segments"]
        fused_seg = torch.cat([arima.segment_fit_outputs(
            1, 1, torch.from_numpy(panel[s:s + step]).to(dev),
            device=dev)[0] for s in range(0, panel.shape[0], step)]).cpu()
        res = FitEngine().stream_fit(panel, "arima", chunk_size=step,
                                     collect=True, device=dev, p=1, d=0,
                                     q=1)
        staged_seg, _ = ls_api._collect_segment_coefs(
            res, lf.plan.n_segments, 3, panel.dtype)
        seg_bitwise = _bitwise_equal(fused_seg.numpy(), staged_seg)
        d_comb = float(np.abs(lf_s.coefficients.cpu().numpy()
                              - coefs).max())
        row["staged"] = {"fit_s": staged_s, "launches": staged_launches,
                         "segments_bitwise": seg_bitwise,
                         "combined_max_abs_diff": d_comb,
                         "combined_bitwise": d_comb == 0.0}
        chk(seg_bitwise, "long_path: the staged path's per-segment "
                           "coefficients are not the fused path's bit for "
                           "bit")
        chk(d_comb <= LONG_STAGED_TOL,
              f"long_path: staged and fused combined coefficients differ "
              f"by {d_comb} (bound {LONG_STAGED_TOL})")
        chk(staged_launches["arma_lm_fit"] == lf_s.stream_stats[
              "n_chunks"], f"long_path staged: {staged_launches} for "
              f"{lf_s.stream_stats['n_chunks']} chunks")

        # -- the LM-fit kernel at these shapes -------------------------------
        row["lm_fit"] = long_lm_vs_plain(panel, dev)
        chk(row["lm_fit"]["vs_plain_fun_within"] >= LONG_PLAIN_SHARE,
              f"long_path: arma_lm_fit vs the plain LM "
              f"({LONG_PLAIN_ITER} iterations, {panel.shape}): fun within "
              f"{LONG_PLAIN_RTOL:g} on {row['lm_fit']['vs_plain_fun_within']}"
              f" of lanes (floor {LONG_PLAIN_SHARE})")
        del panel

        # -- auto=True ---------------------------------------------------------
        _zero_lm_counts()
        _sync(dev)
        t0 = time.perf_counter()
        lf_a = longseries.fit_long(series, order=(1, 0, 1), auto=True,
                                   warn=False, device=dev)
        _sync(dev)
        auto_s = time.perf_counter() - t0
        auto_launches = _lm_counts()
        hist = collections.Counter(
            f"({int(p)},{int(q)})" for p, _, q in lf_a.segment_orders)
        row["auto"] = {"fit_s": auto_s, "launches": auto_launches,
                       "stats_launches": lf_a.stream_stats[
                           "lm_fit_launches"],
                       "segment_orders": dict(sorted(hist.items())),
                       "pi1": float(lf_a.coefficients[1]),
                       "segments_weighted": lf_a.combined.n_weighted}
        chk(auto_launches["arma_lm_fit"]
              == lf_a.stream_stats["lm_fit_launches"] == 37,
              f"long_path auto: {auto_launches['arma_lm_fit']} arma_lm_fit "
              f"launches, stats say {lf_a.stream_stats['lm_fit_launches']}"
              f" (want C + 1 = 37)")
        chk(auto_launches["arma_ne"] == 0,
              f"long_path auto launched arma_ne: {auto_launches}")

        # -- 10⁸ observations --------------------------------------------------
        g = torch.Generator(device=dev)
        g.manual_seed(LONG_SEED)
        t0 = time.perf_counter()
        from spark_timeseries_tpu_torch.ops.scan_parallel import ar1_filter
        e = torch.randn(huge_obs + 1, generator=g, device=dev)
        huge = ar1_filter(e[1:] + 0.4 * e[:-1], 0.1, 0.6).cpu().numpy()
        del e
        gen_s = time.perf_counter() - t0
        _zero_lm_counts()
        _sync(dev)
        t0 = time.perf_counter()
        lf_h = longseries.fit_long(huge, order=(1, 0, 1), warn=False,
                                   device=dev)
        _sync(dev)
        huge_fit_s = time.perf_counter() - t0
        huge_launches = _lm_counts()
        # the kernel against the plain LM on the first lanes of the fused
        # chunks (65536 steps a lane)
        pl = lf_h.plan
        huge_vs_plain = start_lm_vs_plain(np.stack([
            huge[pl.head_drop + k * pl.seg_len:][:pl.window]
            for k in range(min(LONG_PLAIN_LANES, pl.n_segments))]), 1, 1,
            dev, plain_pool)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        lf_h.forecast_origin()
        _sync(dev)
        origin_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base) \
            if dev.type == "cuda" else None
        fc_h = lf_h.forecast(24)
        pi1_h = float(lf_h.coefficients[1])
        row["hundred_million"] = {
            "n_obs": huge_obs, "generate_s": gen_s,
            "n_segments": lf_h.plan.n_segments, "seg_len": lf_h.plan.seg_len,
            "n_chunks": lf_h.stream_stats["n_chunks"],
            "fit_s": huge_fit_s, "obs_per_s": lf_h.plan.n_used / huge_fit_s,
            "forecast_origin_s": origin_s,
            "forecast_origin_peak_bytes": peak, "launches": huge_launches,
            "pi1": pi1_h, "used_wls": lf_h.combined.used_wls,
            "forecast_finite": bool(np.isfinite(fc_h).all())}
        chk(huge_launches["arma_lm_fit"] == lf_h.stream_stats["n_chunks"],
              f"long_path 10⁸: {huge_launches} for "
              f"{lf_h.stream_stats['n_chunks']} chunks")
        chk(abs(pi1_h - 1.0) < LONG_PI1_TOL and np.isfinite(fc_h).all(),
              f"long_path 10⁸: π₁ = {pi1_h}, forecast finite "
              f"{bool(np.isfinite(fc_h).all())}")
        del huge, lf_h

        # -- models.arima.fit_long against the direct fit ---------------------
        n_u, obs_u, seg_u = ultra
        vals = torch.from_numpy(synthetic_arima_panel(n_u, obs_u,
                                                      ULTRA_SEED)).to(dev)
        _zero_lm_counts()
        _sync(dev)
        t0 = time.perf_counter()
        direct = arima.fit(2, 1, 2, vals, warn=False, device=dev)
        _sync(dev)
        direct_s = time.perf_counter() - t0
        st: dict = {}
        t0 = time.perf_counter()
        seg = arima.fit_long(2, 1, 2, vals, segment_len=seg_u, warn=False,
                             device=dev, stats=st)
        _sync(dev)
        seg_s = time.perf_counter() - t0
        ultra_launches = _lm_counts()
        # the kernel against the plain LM on series 0's last segments, the
        # lanes arima.fit_long gave it (float32 differences, as on the card)
        d0 = np.diff(vals[0].cpu().numpy())
        k_u = min(LONG_PLAIN_LANES, d0.size // seg_u)
        ultra_vs_plain = start_lm_vs_plain(
            d0[d0.size - k_u * seg_u:].reshape(k_u, seg_u), 2, 2, dev,
            plain_pool)
        dc = (direct.coefficients - seg.coefficients).abs().cpu().numpy()
        row["arima_fit_long"] = {
            "shape": [n_u, obs_u], "segment_len": seg_u,
            "direct_s": direct_s, "direct_obs_per_s": n_u * obs_u / direct_s,
            "fit_long_s": seg_s, "fit_long_obs_per_s": n_u * obs_u / seg_s,
            "precision_s": st["precision_s"],
            "max_abs_diff_series0": float(dc[0].max()),
            "max_abs_diff_all": float(dc.max()),
            "launches": ultra_launches,
            "converged": bool(seg.diagnostics.converged.all())}
        chk(dc[0].max() < ULTRA_TOL,
              f"long_path: arima.fit_long differs from the direct fit by "
              f"{dc[0].max()} (bound {ULTRA_TOL}, bench_suite.py's check)")
        chk(ultra_launches["arma_lm_fit"] == 2,
              f"long_path arima.fit_long: {ultra_launches} (want one launch"
              f" for the direct fit and one for the segments)")

        # -- against float64 on the CPU ---------------------------------------
        head = series[:LONG_REF_OBS]
        lf32 = longseries.fit_long(head, order=(1, 0, 1), warn=False,
                                   seg_len=LONG_REF_SEG, device=dev)
        fc32 = lf32.forecast(24)
        want = ref[1].get()
        d_coef = float(np.abs(lf32.coefficients.cpu().numpy()
                              - want["coefficients"]).max())
        d_fc = float((np.abs(fc32 - want["forecast"])
                      / np.maximum(1.0, np.abs(want["forecast"]))).max())
        d_pin = float((np.abs(want["forecast"] - want["sequential_forecast"])
                       / np.maximum(1.0, np.abs(want["forecast"]))).max())
        row["vs_float64"] = {"n_obs": LONG_REF_OBS, "seg_len": LONG_REF_SEG,
                             "n_segments": lf32.plan.n_segments,
                             "max_abs_coef_diff": d_coef,
                             "forecast_max_rel_diff": d_fc,
                             "f64_origin_vs_sequential": d_pin,
                             "cpu_fit_s": want["fit_s"],
                             "cpu_seconds": want["seconds"]}
        chk(d_coef <= LONG_REF_COEF_TOL,
              f"long_path: combined coefficients differ from float64 by "
              f"{d_coef} (bound {LONG_REF_COEF_TOL})")
        chk(d_fc <= LONG_REF_FC_RTOL,
              f"long_path: forecast(24) differs from float64 by {d_fc} "
              f"(bound {LONG_REF_FC_RTOL})")
        chk(d_pin <= LONG_PIN_RTOL,
              f"long_path: the float64 forecast off the recovered origin "
              f"differs from the sequential filter's by {d_pin} (bound "
              f"{LONG_PIN_RTOL})")

        # -- the LM-fit kernel against the plain LM at the long windows ------
        row["lm_fit_vs_plain"] = {"hundred_million": huge_vs_plain(),
                                  "arima_fit_long": ultra_vs_plain()}
        for key, r in row["lm_fit_vs_plain"].items():
            check_lm_vs_plain(chk, r, f"long_path {key}")
    finally:
        ref[0].terminate()
        ref[0].join()
        plain_pool.terminate()
        plain_pool.join()
    row["launches"] = {
        "arma_lm_fit": launches["arma_lm_fit"]
        + staged_launches["arma_lm_fit"] + huge_launches["arma_lm_fit"]
        + ultra_launches["arma_lm_fit"],
        "arma_lm_fit_grid": auto_launches["arma_lm_fit"],
        "arma_ne": launches["arma_ne"] + staged_launches["arma_ne"]
        + auto_launches["arma_ne"] + huge_launches["arma_ne"]
        + ultra_launches["arma_ne"],
        "arma_css": launches["arma_css"] + staged_launches["arma_css"]
        + auto_launches["arma_css"] + huge_launches["arma_css"]
        + ultra_launches["arma_css"]}
    row["seconds"] = time.perf_counter() - t_phase
    row["failed_checks"] = chk.failed
    emit(row)
    chk.raise_first()
    return row


def _bt_arma(S, n, phi, theta, seed, burn=BT_BURN):
    """``bench.py``'s backtest demo ARMA generator (intercept 2)."""
    r = np.random.default_rng(seed)
    e = r.standard_normal((S, n + burn))
    y = np.zeros((S, n + burn))
    for t in range(1, n + burn):
        ar = sum(p * y[:, t - 1 - i] for i, p in enumerate(phi))
        ma = sum(q * e[:, t - 1 - i] for i, q in enumerate(theta))
        y[:, t] = 2.0 + ar + e[:, t] + ma
    return y[:, burn:]


def _bt_ses(S, n, alpha, seed):
    """``bench.py``'s backtest demo local level (SES's own process)."""
    r = np.random.default_rng(seed)
    e = r.standard_normal((S, n))
    y = np.zeros((S, n))
    lvl = np.full(S, 10.0)
    for t in range(n):
        y[:, t] = lvl + e[:, t]
        lvl = lvl + alpha * e[:, t]
    return y


def backtest_demo_panel(S: int, n: int = BT_OBS):
    """``bench.py:1110-1160``'s panel at ``S`` series a family: AR(1),
    ARMA(1,1) and SES, float32, and the index of each series' true
    candidate in ``BT_GRID`` (ar(1) 0, arima(1,0,1) 2, ewma 3)."""
    panel = np.concatenate([_bt_arma(S, n, (0.8,), (), 101),
                            _bt_arma(S, n, (0.4,), (0.9,), 102),
                            _bt_ses(S, n, 0.4, 103)]).astype(np.float32)
    return panel, np.repeat([0, 2, 3], S)


def _span_s(before, after, name):
    key = "backtest.backtest_panel/" + name
    return after.get(key, {}).get("total_s", 0.0) \
        - before.get(key, {}).get("total_s", 0.0)


def phase_backtest_path(dev, wide=BT_WIDE, long_obs=BT_LONG_OBS):
    """Rolling-origin backtesting on the card, float32 (module docstring,
    27)."""
    import torch

    from spark_timeseries_tpu_torch.backtest import (CandidateGrid,
                                                     backtest_panel,
                                                     evaluate_candidate,
                                                     plan_origins)
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.utils import metrics

    row = {"phase": "backtest_path"}
    chk = _Checks()
    t_phase = time.perf_counter()
    grid = CandidateGrid(BT_GRID, horizons=BT_HORIZONS)
    arima_idx = [c.family for c in grid.candidates].index("arima")

    # -- bench.py's size, against float64 on the CPU ---------------------
    panel, truth = backtest_demo_panel(BT_SERIES)
    _zero_lm_counts()
    t0 = time.perf_counter()
    rep = backtest_panel(panel, grid, device=dev, **BT_SCHEDULE)
    bench_s = time.perf_counter() - t0
    bench_launches = _lm_counts()
    t0 = time.perf_counter()
    ref = backtest_panel(panel.astype(np.float64), grid, device="cpu",
                         **BT_SCHEDULE)
    cpu_s = time.perf_counter() - t0
    same = rep.champion == ref.champion
    rel = {m: np.abs(rep.champion_score(m) - ref.champion_score(m))
           / np.abs(ref.champion_score(m)) for m in ("smape", "mase")}
    row["bench"] = {
        "shape": list(panel.shape), "candidates": len(grid),
        "n_origins": rep.schedule.n_origins, "seconds": bench_s,
        "champion_smape": float(np.nanmean(rep.champion_score("smape"))),
        "champion_mase": float(np.nanmean(rep.champion_score("mase"))),
        "true_model_recovery": float(np.mean(rep.champion == truth)),
        "coverage_mean": float(np.nanmean(rep.horizon_table("coverage"))),
        "champion_counts": rep.champion_counts(),
        "launches": bench_launches,
        "f64_champion_smape": float(np.nanmean(ref.champion_score("smape"))),
        "f64_champion_mase": float(np.nanmean(ref.champion_score("mase"))),
        "f64_true_model_recovery": float(np.mean(ref.champion == truth)),
        "champions_equal_share": float(same.mean()),
        "score_max_rel_diff": {m: float(np.nanmax(np.where(same, v, 0.0)))
                               for m, v in rel.items()},
        "cpu_seconds": cpu_s}
    chk(same.mean() >= BT_CHAMP_FLOOR,
          f"backtest_path: champions equal the float64 CPU run's on "
          f"{same.mean():.4f} of series (floor {BT_CHAMP_FLOOR})")
    worst = max(row["bench"]["score_max_rel_diff"].values())
    chk(worst <= BT_SCORE_RTOL,
          f"backtest_path: champion scores differ from float64 by {worst} "
          f"relative (bound {BT_SCORE_RTOL})")
    chk(bench_launches["arma_lm_fit"]
          == rep.stream_stats[arima_idx]["n_chunks"],
          f"backtest_path bench: {bench_launches} for the arima "
          f"candidate's {rep.stream_stats[arima_idx]['n_chunks']} chunks")

    # -- widened to 3 x wide series ---------------------------------------
    big, _ = backtest_demo_panel(wide)
    spans0 = metrics.get_registry().snapshot()["spans"]
    _zero_lm_counts()
    _sync(dev)
    t0 = time.perf_counter()
    rep_w = backtest_panel(big, grid, device=dev, **BT_SCHEDULE)
    _sync(dev)
    wide_s = time.perf_counter() - t0
    wide_launches = _lm_counts()
    spans1 = metrics.get_registry().snapshot()["spans"]
    st_a = rep_w.stream_stats[arima_idx]
    row["wide"] = {
        "shape": list(big.shape), "seconds": wide_s,
        "series_candidates_per_s": big.shape[0] * len(grid) / wide_s,
        "fit_s": _span_s(spans0, spans1, "backtest.fit"),
        "replay_s": _span_s(spans0, spans1, "backtest.replay"),
        "score_s": _span_s(spans0, spans1, "backtest.score"),
        "champion_counts": rep_w.champion_counts(),
        "champion_mase": float(np.nanmean(rep_w.champion_score("mase"))),
        "arima_chunks": st_a["n_chunks"], "launches": wide_launches}
    chk(wide_launches["arma_lm_fit"] == st_a["n_chunks"]
          == st_a["lm_fit_launches"],
          f"backtest_path wide: {wide_launches['arma_lm_fit']} arma_lm_fit "
          f"launches for the arima candidate's {st_a['n_chunks']} chunks")
    chk(wide_launches["arma_ne"] == 0,
          f"backtest_path wide launched arma_ne: {wide_launches}")
    # the kernel against the plain LM on the first lanes of the arima
    # candidate's fit window
    fs, ft = rep_w.schedule.fit_window()
    row["lm_fit_vs_plain"] = start_lm_vs_plain(
        big[:LONG_PLAIN_LANES, fs:ft], 1, 1, dev)()
    check_lm_vs_plain(chk, row["lm_fit_vs_plain"], "backtest_path wide")

    # -- pinned-gain replay against the refilter oracle -----------------
    lanes = big[::max(1, big.shape[0] // BT_PIN_LANES)][:BT_PIN_LANES]
    sched = plan_origins(lanes.shape[1], grid.horizon, **BT_PIN_SCHEDULE)
    fs, ft = sched.fit_window()
    model = arima.fit(1, 0, 1, lanes[:, fs:ft], warn=False, device=dev)
    t0 = time.perf_counter()
    pinned = evaluate_candidate(lanes, model, sched, BT_HORIZONS,
                                device=dev)
    pinned_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = evaluate_candidate(lanes, model, sched, BT_HORIZONS,
                                replay="refilter", device=dev)
    oracle_s = time.perf_counter() - t0
    d_pin = float(np.nanmax(np.abs(pinned.forecasts - oracle.forecasts)
                            / np.maximum(1.0, np.abs(oracle.forecasts))))
    row["pinned_vs_refilter"] = {
        "lanes": int(lanes.shape[0]), "n_origins": sched.n_origins,
        "pinned_s": pinned_s, "refilter_s": oracle_s,
        "forecast_max_rel_diff": d_pin,
        "nan_equal": bool((np.isnan(pinned.forecasts)
                           == np.isnan(oracle.forecasts)).all())}
    chk(d_pin <= BT_PIN_RTOL and row["pinned_vs_refilter"]["nan_equal"],
          f"backtest_path: the pinned-gain replay differs from the refilter "
          f"oracle by {d_pin} (bound {BT_PIN_RTOL})")

    # -- the long route ------------------------------------------------------
    long_panel = np.stack([long_series(long_obs, LONG_SEED + 1 + i, dev)
                           for i in range(BT_LONG_SERIES)])
    lgrid = CandidateGrid({"arima": [(1, 0, 1)]}, horizons=BT_HORIZONS)
    _zero_lm_counts()
    _sync(dev)
    t0 = time.perf_counter()
    rep_l = backtest_panel(long_panel, lgrid, device=dev, n_origins=8,
                           min_train=BT_LONG_TRAIN,
                           long_threshold=BT_LONG_TRAIN)
    long_s = time.perf_counter() - t0
    long_launches = _lm_counts()
    st_l = rep_l.stream_stats[0]
    row["long_route"] = {"shape": list(long_panel.shape),
                         "path": st_l["path"], "seconds": long_s,
                         "launches": long_launches,
                         "stats_launches": st_l["lm_fit_launches"],
                         "scores_mase": rep_l.scores_mase[:, 0].tolist()}
    chk(st_l["path"] == "longseries",
          f"backtest_path: the arima candidate took the {st_l['path']} "
          f"route at {long_panel.shape} (want longseries)")
    chk(long_launches["arma_lm_fit"] == st_l["lm_fit_launches"]
          == BT_LONG_SERIES and np.isfinite(rep_l.scores_mase).all(),
          f"backtest_path long route: {long_launches} (stats "
          f"{st_l['lm_fit_launches']}), scores {rep_l.scores_mase}")
    row["launches"] = {
        name: bench_launches[name] + wide_launches[name]
        + long_launches[name] for name in bench_launches}
    row["seconds"] = time.perf_counter() - t_phase
    row["failed_checks"] = chk.failed
    emit(row)
    chk.raise_first()
    return row


# ---------------------------------------------------------------------------
# slice 14: the fleet (statespace.fleet, statespace.runtime)
# ---------------------------------------------------------------------------

FLEET_TENANTS = 256        # F1: ARIMA(2,1,2)+c tenants of 512 series:
FLEET_SERIES = 512         # serving_path's 131072 lanes in one group
FLEET_HW_TENANTS = 16      # F1's second group: Holt-Winters, period 12
FLEET_ROUNDS = 32          # bench.py:927's BENCH_FLEET_TICKS default
FLEET_HIST = 32            # history columns (a session's start filters
#                            them, launch-bound: the depth cut of the phase)
FLEET_RING = 64            # the F1 tenants' per-lane history ring
FLEET_MIRRORED = 8         # F1 tenants held bitwise against solo sessions
FLEET_F2 = (64, 16)        # bench.py:925-926: tenants x series
FLEET_F2_ROUNDS = 16       # F2's rounds (each replayed by 64 solo sessions)
FLEET_CRASH_ROUNDS = 8     # F2's rounds under the pump_crash fault
FLEET_CHILD_TICKS = 14     # the kill -9 child's ticks (2 still queued)

# the kill -9 child: one tenant on the card, 12 ticks dispatched and 2
# queued, then drain() under drop_tenant_process (SIGKILL after commit)
_FLEET_CHILD = r"""
import os, sys
import numpy as np
import torch
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.statespace import fleet, serving
from spark_timeseries_tpu_torch.utils import resilience
d = np.load(os.environ["STS_FLEET_CHILD_IN"])
dev = torch.device(os.environ["STS_FLEET_CHILD_DEVICE"])
model = arima.ARIMAModel(2, 1, 2, torch.from_numpy(d["coefficients"]).to(dev),
                         True)
sched = fleet.FleetScheduler(auto_pump=False, device=dev)
sched.attach(serving.ServingSession.start(
    model, d["history"], label="mig", history_ring=int(d["ring"]),
    device=dev))
live = d["live"]
for t in range(live.shape[1] - 2):
    sched.submit("mig", live[:, t])
    sched.pump()
sched.submit("mig", live[:, -2])
sched.submit("mig", live[:, -1])
with resilience.fault_injection("drop_tenant_process"):
    sched.drain("mig", os.environ["STS_FLEET_CHILD_BUNDLE"])
print("UNREACHABLE: drain survived drop_tenant_process", flush=True)
sys.exit(3)
"""


def start_fleet_child(coefficients, history, live, ring, dev, work):
    """Start the kill -9 child (a process of its own on ``dev``) and
    return ``(process, bundle path, incident dir, inputs)``."""
    inp = os.path.join(work, "child-in.npz")
    np.savez(inp, coefficients=coefficients, history=history, live=live,
             ring=np.int64(ring))
    bundle = os.path.join(work, "child-bundle")
    incidents = os.path.join(work, "child-incidents")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, STS_FLEET_CHILD_IN=inp,
               STS_FLEET_CHILD_BUNDLE=bundle,
               STS_FLEET_CHILD_DEVICE=str(dev), STS_INCIDENT_DIR=incidents,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen([sys.executable, "-c", _FLEET_CHILD], cwd=here,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, bundle, incidents, inp


def _fleet_dispatch_ops(sched, dev):
    """Device operations (runtime records, :func:`_cuda_ops`) of one
    coalesced dispatch of the scheduler's widest group: what
    ``FleetScheduler._dispatch_group`` puts on the card (the members'
    state and health gathered, the tick buffers' copies, the tick, the
    stacked results' one copy back), on all-missing ticks; the group's
    SSM is gathered outside, as the dispatch's cache holds it between
    heals."""
    import torch

    from spark_timeseries_tpu_torch.statespace import fleet, serving

    key, labels = max(sched._groups.items(), key=lambda kv: len(kv[1]))
    bucket, _, meta, policy, quality = key
    sess = [sched.session(la) for la in labels]
    slots = fleet._slots_for(len(sess))
    ssm = fleet._gather([s._ssm for s in sess], slots)
    y = np.full((slots * bucket,), np.nan, sess[0]._dtype)
    off = np.zeros_like(y)

    def one():
        _, h2, _, v, f, ll, an = serving._update_impl(
            meta, policy, quality, ssm,
            fleet._gather([s._state for s in sess], slots),
            fleet._gather([s._health for s in sess], slots), None,
            torch.from_numpy(y).to(dev), torch.from_numpy(off).to(dev))
        torch.stack([v, f, ll, an, h2.ew, h2.status.to(v.dtype)]).cpu()

    return len(_cuda_ops(one)), len(sess)


def _trace_dispatches(sched, log):
    """Record every coalesced dispatch of ``sched``: its group's family,
    members and slots, the tick's wall (the report's: the tick and its
    results' copy to the host, ms) and the whole call's (gather and the
    members' absorb included)."""
    orig = sched._dispatch_group

    def dispatch(key, members, deadline_flush=False):
        t0 = time.perf_counter()
        rep = orig(key, members, deadline_flush=deadline_flush)
        log.append({"family": rep["key"][1], "tenants": rep["tenants"],
                    "slots": rep["slots"], "tick_ms": rep["wall_ms"],
                    "call_ms": (time.perf_counter() - t0) * 1e3})
        return rep

    sched._dispatch_group = dispatch


def _record_ticks(sess, log):
    orig = sess._absorb_tick

    def absorb(host, state2, health2, out, dt_s, qstate2=None,
               lineage=None):
        log.append(out)
        return orig(host, state2, health2, out, dt_s, qstate2,
                    lineage=lineage)

    sess._absorb_tick = absorb


def _sessions_bitwise(a, b) -> bool:
    """State and health of two sessions, bit for bit (real lanes)."""
    n = a.n_series
    return a.ticks_seen == b.ticks_seen and _bits_equal(
        [t[:n].float() for t in (*a._state, *a._health)],
        [t[:n].float() for t in (*b._state, *b._health)])


def _ticks_bitwise(got, want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(np.ascontiguousarray(x).view(np.uint8),
                       np.ascontiguousarray(y).view(np.uint8))
        for g, w in zip(got, want) for x, y in zip(g, w))


def _dispatch_stats(log, family):
    rows = [r for r in log if r["family"] == family]
    if not rows:
        return {"dispatches": 0}
    tick = [r["tick_ms"] for r in rows]
    call = [r["call_ms"] for r in rows]
    return {"dispatches": len(rows),
            "tenants_per_dispatch": float(np.mean([r["tenants"]
                                                   for r in rows])),
            "full_dispatches": sum(r["tenants"] == max(x["tenants"]
                                                       for x in rows)
                                   for r in rows),
            "first_tick_ms": tick[0], "first_call_ms": call[0],
            "tick_p50_ms": float(np.percentile(tick, 50)),
            "tick_p95_ms": float(np.percentile(tick, 95)),
            "warm_tick_ms": float(np.median(tick[1:])) if len(tick) > 1
            else None,
            "call_p50_ms": float(np.percentile(call, 50)),
            "call_p95_ms": float(np.percentile(call, 95))}


def phase_fleet_path(panel, hw_panel, dev, smi, tenants=FLEET_TENANTS,
                     series=FLEET_SERIES, hw_tenants=FLEET_HW_TENANTS,
                     rounds=FLEET_ROUNDS, f2=FLEET_F2,
                     f2_rounds=FLEET_F2_ROUNDS,
                     crash_rounds=FLEET_CRASH_ROUNDS,
                     mirrored=FLEET_MIRRORED):
    """The fleet on the card, float32 (module docstring, 28)."""
    import tempfile

    import torch

    from spark_timeseries_tpu_torch.models import arima, holt_winters
    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse
    from spark_timeseries_tpu_torch.statespace import (fleet, runtime,
                                                       serving)
    from spark_timeseries_tpu_torch.utils import (lineage, metrics,
                                                  resilience)

    def counts():
        return {"arma_lm_fit": arma_ne.fit_css_lm.launches,
                "arma_ne": arma_ne.normal_equations.launches,
                "arma_css": arma_ne.css_cost.launches,
                "hw_box_fit": hw_sse.box_fit.launches,
                "hw_sse": hw_sse.value_and_grad.launches}

    for w in (arma_ne.fit_css_lm, arma_ne.normal_equations,
              arma_ne.css_cost, hw_sse.box_fit, hw_sse.value_and_grad):
        w.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    extra = 3                      # a restore's next tick, 2 queued ticks
    n1, n_hw = tenants * series, hw_tenants * series
    hist = np.ascontiguousarray(panel[:n1, :FLEET_HIST])
    live = np.ascontiguousarray(
        panel[:n1, FLEET_HIST:FLEET_HIST + rounds + extra])
    hw_split = hw_panel.shape[1] - rounds - extra
    hw_hist = np.ascontiguousarray(hw_panel[:n_hw, :hw_split])
    hw_live = np.ascontiguousarray(hw_panel[:n_hw, hw_split:])
    row = {"phase": "fleet_path", "nvidia_smi": smi,
           "f1": {"tenants": tenants, "series": series,
                  "hw_tenants": hw_tenants, "lanes": n1 + n_hw,
                  "rounds": rounds, "history": FLEET_HIST,
                  "hw_history": hw_split, "history_ring": FLEET_RING}}
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=scratch)
    child = None
    try:
        # -- each group's model, fitted once at the tenant's width
        t0 = time.perf_counter()
        model = arima.fit(2, 1, 2, hist[:series], warn=False, device=dev)
        hw_model = holt_winters.fit(hw_hist[:series], HW_PERIOD,
                                    "additive", device=dev)
        _sync(dev)
        row["fit_s"] = time.perf_counter() - t0
        coefs = model.coefficients.cpu().numpy()
        # the kill -9 child starts now and works while this process does
        child = start_fleet_child(coefs, hist[:series],
                                  live[:series, :FLEET_CHILD_TICKS],
                                  FLEET_RING, dev, work.name)

        # -- F1: the scheduler and its tenants
        reg = metrics.MetricsRegistry()
        sched = fleet.FleetScheduler(fleet.AdmissionPolicy(queue_depth=4),
                                     registry=reg, auto_pump=False,
                                     device=dev, label="f1")
        a_labels = [f"a{i}" for i in range(tenants)]
        h_labels = [f"h{j}" for j in range(hw_tenants)]
        t0 = time.perf_counter()
        for i, la in enumerate(a_labels):
            sched.attach(serving.ServingSession.start(
                model, hist[i * series:(i + 1) * series], label=la,
                registry=reg, history_ring=FLEET_RING, device=dev))
        for j, la in enumerate(h_labels):
            sched.attach(serving.ServingSession.start(
                hw_model, hw_hist[j * series:(j + 1) * series], label=la,
                registry=reg, history_ring=FLEET_RING, device=dev))
        _sync(dev)
        row["f1"]["start_s"] = time.perf_counter() - t0
        row["f1"]["groups"] = sched.n_groups
        picks = sorted({k * tenants // mirrored for k in range(mirrored)})
        mirrors = {}
        fleet_ticks = {}
        for i in picks:
            la = a_labels[i]
            mirrors[la] = serving.ServingSession.start(
                model, hist[i * series:(i + 1) * series],
                history_ring=FLEET_RING, device=dev)
            fleet_ticks[la] = []
            _record_ticks(sched.session(la), fleet_ticks[la])
        t0 = time.perf_counter()
        sched.warmup()
        row["f1"]["warmup_s"] = time.perf_counter() - t0
        row["f1"]["device_ops_per_dispatch"], _ = _fleet_dispatch_ops(
            sched, dev)
        row["f1"]["device_ops_per_solo_tick"] = len(_tick_ops(
            mirrors[a_labels[picks[0]]], live[:series, 0]))
        log = []
        _trace_dispatches(sched, log)

        # -- F1: 32 rounds of blocking submit through the runtime
        ck = os.path.join(work.name, "f1-ck")
        rt = runtime.FleetRuntime(sched, registry=reg, label="f1rt",
                                  policy=runtime.RuntimePolicy(
                                      checkpoint_dir=ck,
                                      pump_interval_s=0.0005))
        lineage.reset()
        rt.start()
        try:
            t0 = time.perf_counter()
            for t in range(rounds):
                for i, la in enumerate(a_labels):
                    rt.submit(la, live[i * series:(i + 1) * series, t],
                              block=True, timeout=120.0)
                for j, la in enumerate(h_labels):
                    rt.submit(la, hw_live[j * series:(j + 1) * series, t],
                              block=True, timeout=120.0)
            quiet = rt.quiesce(timeout=120.0)
            _sync(dev)
            run_s = time.perf_counter() - t0
            lin = lineage.lineage_summary()
        finally:
            t0 = time.perf_counter()
            rt.stop()                      # commits the final generation
            row["f1"]["stop_checkpoint_s"] = time.perf_counter() - t0
        n_ticks = rounds * (tenants + hw_tenants)
        c1 = reg.snapshot()["counters"]
        row["f1"].update(
            run_s=run_s, quiesced=quiet,
            lane_ticks_per_s=rounds * (n1 + n_hw) / run_s,
            ticks_per_s=n_ticks / run_s,
            arima=_dispatch_stats(log, "arima"),
            holt_winters=_dispatch_stats(log, "holt_winters"),
            lineage={"started": lin["started"],
                     "outcomes": lin["outcomes"], "open": lin["open"],
                     "e2e": lin["e2e"], "worst_stage": lin["worst_stage"],
                     "worst_stage_share": lin["worst_stage_share"],
                     "stage_totals_ms": lin["stage_totals_ms"]},
            pump=rt.pump_summary(),
            counters={k: v for k, v in c1.items()
                      if k.startswith("fleet.")})
        check(quiet, "fleet_path F1: the runtime did not quiesce")
        check(c1.get("fleet.pump_restarts", 0) == 0
              and c1.get("fleet.shed_lanes", 0) == 0,
              f"fleet_path F1: pump_restarts "
              f"{c1.get('fleet.pump_restarts', 0)}, shed_lanes "
              f"{c1.get('fleet.shed_lanes', 0)} (both must be 0 outside "
              f"the fault sub-phases)")
        check(lin["outcomes"] == {"delivered": n_ticks}
              and lin["open"] == 0 and lin["duplicate_completions"] == 0,
              f"fleet_path F1: lineage {lin['outcomes']}, open "
              f"{lin['open']}, against {n_ticks} ticks submitted")

        # coalesced ticks bitwise the same ticks through solo sessions
        for la, mirror in mirrors.items():
            i = a_labels.index(la)
            solo = [mirror.update(live[i * series:(i + 1) * series, t])
                    for t in range(rounds)]
            ok = _ticks_bitwise(fleet_ticks[la], solo) \
                and _sessions_bitwise(sched.session(la), mirror)
            check(ok, f"fleet_path F1: tenant {la}'s coalesced ticks are "
                      f"not its solo session's bit for bit")
        row["f1"]["mirrored_tenants"] = len(mirrors)

        # -- stop() and a fresh runtime's restore_latest(): every tenant
        # from the newest generation, bitwise, and the next tick too
        reg2 = metrics.MetricsRegistry()
        sched2 = fleet.FleetScheduler(fleet.AdmissionPolicy(queue_depth=4),
                                      registry=reg2, auto_pump=False,
                                      device=dev, label="f1restored")
        rt2 = runtime.FleetRuntime(sched2, registry=reg2, label="f1rt2",
                                   policy=runtime.RuntimePolicy(
                                       checkpoint_dir=ck))
        gen = runtime.FleetRuntime.latest_generation(ck)
        t0 = time.perf_counter()
        adopted = rt2.restore_latest()
        _sync(dev)
        restore_s = time.perf_counter() - t0
        check(sorted(adopted) == sched.tenants,
              f"fleet_path: restore_latest adopted {len(adopted)} of "
              f"{len(sched.tenants)} tenants")
        same = all(_sessions_bitwise(sched2.session(la), sched.session(la))
                   for la in sched.tenants)
        t = rounds
        for i, la in enumerate(a_labels):
            y = live[i * series:(i + 1) * series, t]
            sched.submit(la, y)
            rt2.submit(la, y, block=False)
        for j, la in enumerate(h_labels):
            y = hw_live[j * series:(j + 1) * series, t]
            sched.submit(la, y)
            rt2.submit(la, y, block=False)
        sched.pump()
        rt2.pump_once()
        nxt = all(_sessions_bitwise(sched2.session(la), sched.session(la))
                  for la in sched.tenants)
        row["restore"] = {"generation": gen[0] if gen else None,
                          "tenants": len(adopted), "restore_s": restore_s,
                          "bitwise": same, "next_tick_bitwise": nxt}
        check(same and nxt, f"fleet_path: the restored fleet is not the "
                            f"stopped one bit for bit ({row['restore']})")
        del sched2, rt2

        # -- drain with queued ticks, adopt elsewhere, replay: bitwise
        la = a_labels[picks[-1]]
        i = a_labels.index(la)
        mirror = mirrors[la]
        mirror.update(live[i * series:(i + 1) * series, rounds])
        for t in (rounds + 1, rounds + 2):
            sched.submit(la, live[i * series:(i + 1) * series, t])
            mirror.update(live[i * series:(i + 1) * series, t])
        path = os.path.join(work.name, "drained")
        t0 = time.perf_counter()
        rep = sched.drain(la, path)
        dest = fleet.FleetScheduler(registry=metrics.MetricsRegistry(),
                                    auto_pump=False, device=dev)
        dest.adopt(path)
        _sync(dev)
        row["drain_adopt"] = {"tenant": la, "pending": rep["pending"],
                              "s": time.perf_counter() - t0,
                              "bitwise": _sessions_bitwise(
                                  dest.session(la), mirror)}
        check(rep["pending"] == 2 and row["drain_adopt"]["bitwise"],
              f"fleet_path: drain / adopt with queued ticks is not bitwise "
              f"({row['drain_adopt']})")
        del sched, dest, mirrors, fleet_ticks, log

        # -- F2: bench.py's 64 tenants x 16 series, the launch-bound end
        n_f2, s_f2 = f2
        rows2 = slice(n1, n1 + n_f2 * s_f2)
        hist2 = np.ascontiguousarray(panel[rows2, :FLEET_HIST])
        live2 = np.ascontiguousarray(
            panel[rows2, FLEET_HIST:FLEET_HIST + f2_rounds + crash_rounds])
        model2 = arima.fit(2, 1, 2, hist2[:s_f2], warn=False, device=dev)
        reg3 = metrics.MetricsRegistry()
        sched3 = fleet.FleetScheduler(fleet.AdmissionPolicy(queue_depth=4),
                                      registry=reg3, auto_pump=False,
                                      device=dev, label="f2")
        labels2 = [f"b{i}" for i in range(n_f2)]
        mirrors2 = {}
        ticks2 = {}
        for i, la in enumerate(labels2):
            h = hist2[i * s_f2:(i + 1) * s_f2]
            sched3.attach(serving.ServingSession.start(
                model2, h, label=la, registry=reg3, device=dev))
            mirrors2[la] = serving.ServingSession.start(model2, h,
                                                        device=dev)
            ticks2[la] = []
            _record_ticks(sched3.session(la), ticks2[la])
        sched3.warmup()
        ops2, _ = _fleet_dispatch_ops(sched3, dev)
        log2 = []
        _trace_dispatches(sched3, log2)

        def run_f2(t_from, t_to, label):
            rt3 = runtime.FleetRuntime(sched3, registry=reg3, label=label,
                                       policy=runtime.RuntimePolicy(
                                           pump_interval_s=0.0005,
                                           watchdog_interval_s=0.01))
            rt3.start()
            try:
                t0 = time.perf_counter()
                for t in range(t_from, t_to):
                    for i, la in enumerate(labels2):
                        rt3.submit(la, live2[i * s_f2:(i + 1) * s_f2, t],
                                   block=True, timeout=120.0)
                quiet = rt3.quiesce(timeout=120.0)
                _sync(dev)
                return quiet, time.perf_counter() - t0, rt3.pump_summary()
            finally:
                rt3.stop(checkpoint=False)

        lineage.reset()
        quiet2, run2_s, _ = run_f2(0, f2_rounds, "f2rt")
        c3 = reg3.snapshot()["counters"]
        lin2 = lineage.lineage_summary()
        row["f2"] = {"tenants": n_f2, "series": s_f2, "rounds": f2_rounds,
                     "lanes": n_f2 * s_f2, "run_s": run2_s,
                     "lane_ticks_per_s": f2_rounds * n_f2 * s_f2 / run2_s,
                     "ticks_per_s": f2_rounds * n_f2 / run2_s,
                     "device_ops_per_dispatch": ops2,
                     "arima": _dispatch_stats(log2, "arima"),
                     "lineage_e2e": lin2["e2e"]}
        check(quiet2 and c3.get("fleet.pump_restarts", 0) == 0
              and c3.get("fleet.shed_lanes", 0) == 0,
              f"fleet_path F2: quiesced {quiet2}, counters "
              f"{ {k: v for k, v in c3.items() if k.startswith('fleet.')} }")

        # -- F2 under pump_crash: restarts, exactly-once, bitwise
        lineage.reset()
        with resilience.fault_injection("pump_crash", n_attempts=3):
            quiet3, crash_s, pump3 = run_f2(f2_rounds,
                                            f2_rounds + crash_rounds,
                                            "f2crash")
        lin3 = lineage.lineage_summary()
        n3 = crash_rounds * n_f2
        row["f2"]["pump_crash"] = {
            "rounds": crash_rounds, "s": crash_s, "quiesced": quiet3,
            "pump_restarts": pump3["restarts"],
            "outcomes": lin3["outcomes"], "open": lin3["open"]}
        check(quiet3 and pump3["restarts"] >= 1
              and lin3["outcomes"] == {"delivered": n3}
              and lin3["open"] == 0,
              f"fleet_path F2 pump_crash: {row['f2']['pump_crash']} "
              f"(restarts >= 1, {n3} delivered, none open)")
        all_t = f2_rounds + crash_rounds
        f2_ok = True
        for i, la in enumerate(labels2):
            solo = [mirrors2[la].update(live2[i * s_f2:(i + 1) * s_f2, t])
                    for t in range(all_t)]
            f2_ok &= _ticks_bitwise(ticks2[la], solo) \
                and _sessions_bitwise(sched3.session(la), mirrors2[la])
        row["f2"]["bitwise"] = f2_ok
        check(f2_ok, "fleet_path F2: coalesced ticks are not the solo "
                     "sessions' bit for bit")
        del sched3, mirrors2, ticks2

        # -- the kill -9 child: its drained tenant, adopted here, bitwise
        proc, bundle, incidents, inp = child
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        child = None
        d = np.load(inp)
        c_model = arima.ARIMAModel(
            2, 1, 2, torch.from_numpy(d["coefficients"]).to(dev), True)
        c_mirror = serving.ServingSession.start(
            c_model, d["history"], history_ring=FLEET_RING, device=dev)
        for t in range(d["live"].shape[1]):
            c_mirror.update(d["live"][:, t])
        c_sched = fleet.FleetScheduler(registry=metrics.MetricsRegistry(),
                                       auto_pump=False, device=dev)
        killed = proc.returncode == -9 and os.path.exists(bundle + ".npz")
        c_ok = False
        if killed:
            c_sched.adopt(bundle)
            c_ok = _sessions_bitwise(c_sched.session("mig"), c_mirror)
        row["kill9_child"] = {
            "returncode": proc.returncode, "bundle": killed,
            "incident": os.path.isdir(incidents) and any(
                "drop_tenant_process" in n for n in os.listdir(incidents)),
            "adopted_bitwise": c_ok}
        check(killed and c_ok and row["kill9_child"]["incident"],
              f"fleet_path: the kill -9 child's drained tenant "
              f"({row['kill9_child']}; stderr {err[-800:]!r})")
    finally:
        if child is not None:
            child[0].kill()
            child[0].communicate()
        work.cleanup()
    launches = counts()
    row["launches"] = launches
    if dev.type == "cuda":
        row["peak_bytes"] = int(torch.cuda.max_memory_allocated())
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    f1a = row["f1"]["arima"]
    emit({"phase": "fleet_summary", "nvidia_smi": smi,
          "f1_lane_ticks_per_s": row["f1"]["lane_ticks_per_s"],
          "f1_dispatch_tick_p50_ms": f1a.get("tick_p50_ms"),
          "f1_dispatch_tick_p95_ms": f1a.get("tick_p95_ms"),
          "f1_dispatch_call_p50_ms": f1a.get("call_p50_ms"),
          "f1_dispatch_call_p95_ms": f1a.get("call_p95_ms"),
          "f1_first_dispatch_ms": f1a.get("first_call_ms"),
          "f1_device_ops_per_dispatch":
              row["f1"]["device_ops_per_dispatch"],
          "f1_lineage_e2e": row["f1"]["lineage"]["e2e"],
          "f1_warmup_s": row["f1"]["warmup_s"],
          "f2_lane_ticks_per_s": row["f2"]["lane_ticks_per_s"],
          "f2_dispatch_tick_p50_ms": row["f2"]["arima"].get("tick_p50_ms"),
          "f2_device_ops_per_dispatch": row["f2"]["device_ops_per_dispatch"],
          "f2_lineage_e2e": row["f2"]["lineage_e2e"],
          "peak_bytes": row.get("peak_bytes"), "launches": launches,
          "seconds": row["seconds"]})
    # the two groups' fits (F1: ARIMA and Holt-Winters) and F2's ARIMA
    # fit; the ticks launch no kernel of the port
    check(launches["arma_lm_fit"] == 2 and launches["hw_box_fit"] == 1,
          f"fleet_path launched arma_lm_fit {launches['arma_lm_fit']} "
          f"(2: F1 and F2 fits) and hw_box_fit {launches['hw_box_fit']} "
          f"(1: F1's Holt-Winters fit)")
    check(launches["arma_ne"] == 0 and launches["arma_css"] == 0
          and launches["hw_sse"] == 0,
          f"fleet_path launched a one-pass kernel: {launches}")
    return row


# ---------------------------------------------------------------------------
# the engine's durability tier, ops.decompose, ops.detect_anomalies
# ---------------------------------------------------------------------------

DUR_HEAD_CHUNKS = 4        # the fault cases' rows: 4 full-width chunks
DUR_DEADLINE_S = 2.0       # the hang case's per-chunk deadline ...
DUR_HANG_S = 4.0           # ... and its injected hang
DUR_HW_CHUNKS = 2          # the Holt-Winters journal's chunks
DUR_REF_ROWS = 256         # rows of the float64 CPU decompose / anomalies
DUR_RTOL = 1e-5            # of the lane's largest |entry| (float32 means)
DUR_Z_MARGIN = 1e-4        # flags compared where |score - z| exceeds this
ANOM_CONF = 0.99
ANOM_BURN = 3              # d + max(p, q) of the north star's ARIMA(2,1,2)

# the kill -9 child: the head rows streamed with a journal on the card under
# kill_after_chunk at chunk 1 (SIGKILL after its commit)
_DURABLE_KILL_CHILD = r"""
import os, sys
import numpy as np
import torch
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.utils import resilience
v = np.load(os.environ["STS_DURABLE_IN"])
dev = torch.device(os.environ["STS_DURABLE_DEVICE"])
with resilience.fault_injection("kill_after_chunk", chunk_index=1):
    engine.FitEngine().stream_fit(
        v, "arima", chunk_size=int(os.environ["STS_DURABLE_CHUNK"]),
        journal=os.environ["STS_DURABLE_JOURNAL"], p=2, d=1, q=2,
        device=dev)
print("UNREACHABLE: the stream survived kill_after_chunk", flush=True)
sys.exit(3)
"""

# the real-OOM child: caps its allocator between one warm chunk's peak at
# half and at full width, then streams the head rows
_DURABLE_OOM_CHILD = r"""
import json, os
import numpy as np
import torch
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.utils import resilience
v = np.load(os.environ["STS_DURABLE_IN"])
dev = torch.device(os.environ["STS_DURABLE_DEVICE"])
chunk = int(os.environ["STS_DURABLE_CHUNK"])
eng = engine.FitEngine()
kw = dict(chunk_size=chunk, p=2, d=1, q=2, device=dev, collect=True)
part = np.ascontiguousarray(v[:chunk])
eng.stream_fit(part, "arima", **kw)
peaks = {}
for name in ("full", "half"):
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    if name == "full":
        eng.stream_fit(part, "arima", **kw)
    else:
        with resilience.fault_injection("oom_chunk", chunk_index=0):
            eng.stream_fit(part, "arima", **kw)
    peaks[name] = int(torch.cuda.max_memory_allocated(dev))
cap = (peaks["full"] + peaks["half"]) // 2
torch.cuda.empty_cache()
total = torch.cuda.get_device_properties(dev).total_memory
torch.cuda.set_per_process_memory_fraction(cap / total, dev)
res = eng.stream_fit(v, "arima", **kw)
np.save(os.environ["STS_DURABLE_OUT"],
        np.concatenate([m.coefficients.numpy() for m in res.models]))
print(json.dumps({"peak_full": peaks["full"], "peak_half": peaks["half"],
                  "cap": cap, "n_fitted": res.n_fitted,
                  "degraded_chunks": res.stats["degraded_chunks"],
                  "dead_chunks": res.stats["dead_chunks"],
                  "chunk_failures": [f["error"][:200]
                                     for f in res.chunk_failures],
                  "ranges": res.stats["collected_ranges"],
                  "lm_fit_launches": res.stats["lm_fit_launches"]}),
      flush=True)
"""


def start_durable_child(code: str, head: str, dev, chunk: int,
                        **env_extra):
    """A child process of its own on ``dev`` over the head rows saved at
    ``head``: ``(process, its environment)``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, STS_DURABLE_IN=head, STS_DURABLE_DEVICE=str(dev),
               STS_DURABLE_CHUNK=str(chunk),
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               **env_extra)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=here, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc


def _wait_child(proc, timeout=600):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return out, err


def _coef_rows(models) -> np.ndarray:
    return np.concatenate([m.coefficients.cpu().numpy() for m in models])


def _models_bitwise(got, want) -> bool:
    """Two collected model lists cover the same lanes bit for bit (their
    chunking may differ: a halved chunk's two models against one)."""
    import torch

    def lanes(models, field):
        parts = []
        for m in models:
            v = m.diagnostics if field != "coefficients" else m
            parts.append(getattr(v, field).cpu())
        return torch.cat(parts).numpy()

    return all(_bitwise_equal(lanes(got, f), lanes(want, f))
               for f in ("coefficients", "converged", "n_iter", "fun"))


def _lane_rel(got: np.ndarray, want: np.ndarray, scale: np.ndarray
              ) -> float:
    """Largest |got - want| over the lane's scale (equal values, the
    same infinity and NaN on both sides count as equal, NaN on one side
    only as infinitely apart; a scale that is not positive and finite,
    an all-NaN lane's, counts as 1)."""
    got = got.astype(np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(got - want))
    d = np.where(np.isnan(d), np.inf, d)
    scale = np.where(np.isfinite(scale) & (scale > 0), scale, 1.0)
    return float(np.max(d / scale))


def phase_durable_path(panel, hw_panel, dev, smi, chunk=CHUNK,
                       head_chunks=DUR_HEAD_CHUNKS, hw_chunks=DUR_HW_CHUNKS,
                       long_obs=LONG_N_OBS, bt_series=BT_SERIES,
                       ref_rows=DUR_REF_ROWS, deadline_s=DUR_DEADLINE_S,
                       hang_s=DUR_HANG_S):
    """The engine's durability tier, ``ops.decompose`` and
    ``ops.detect_anomalies`` on the card, float32 (module docstring,
    29)."""
    import tempfile

    import torch

    from spark_timeseries_tpu_torch import longseries, ops
    from spark_timeseries_tpu_torch.backtest import (CandidateGrid,
                                                     backtest_panel)
    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse
    from spark_timeseries_tpu_torch.utils.durability import BackoffPolicy
    from spark_timeseries_tpu_torch.utils import resilience

    wrappers = {"arma_lm_fit": arma_ne.fit_css_lm,
                "arma_ne": arma_ne.normal_equations,
                "arma_css": arma_ne.css_cost,
                "hw_box_fit": hw_sse.box_fit,
                "hw_sse": hw_sse.value_and_grad}

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def delta(before):
        now = counts()
        return {k: now[k] - before[k] for k in now}

    for w in wrappers.values():
        w.launches = 0
    row = {"phase": "durable_path", "nvidia_smi": smi}
    chk = _Checks()
    t_phase = time.perf_counter()
    eng = FitEngine()
    kw = dict(chunk_size=chunk, p=2, d=1, q=2, device=dev, collect=True)
    n_all = panel.shape[0]
    n_chunks = -(-n_all // chunk)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=scratch)
    children = []
    try:
        # -- the whole panel: journal-free, then journaled -----------------
        c0 = counts()
        _sync(dev)
        t0 = time.perf_counter()
        plain = eng.stream_fit(panel, "arima", **kw)
        plain_s = time.perf_counter() - t0
        plain_l = delta(c0)
        c0 = counts()
        t0 = time.perf_counter()
        jr = eng.stream_fit(panel, "arima",
                            journal=os.path.join(work.name, "whole"), **kw)
        jr_s = time.perf_counter() - t0
        jr_l = delta(c0)
        row["whole"] = {
            "series": n_all, "chunks": n_chunks,
            "plain_s": plain_s, "plain_series_per_s": n_all / plain_s,
            "journal_s": jr_s, "journal_series_per_s": n_all / jr_s,
            "digest_s": jr.stats["digest_s"],
            "commit_s": jr.stats["commit_s"],
            "commits": jr.stats["journal_commits"],
            "plain_launches": plain_l["arma_lm_fit"],
            "journal_launches": jr_l["arma_lm_fit"],
            "bitwise": _models_bitwise(jr.models, plain.models)}
        chk(row["whole"]["commits"] == n_chunks
            and plain_l["arma_lm_fit"] == n_chunks
            and jr_l["arma_lm_fit"] == n_chunks
            and row["whole"]["bitwise"],
            f"durable_path whole panel: {row['whole']} ({n_chunks} commits "
            f"and launches each, journaled models bitwise the plain ones)")

        # -- the fault cases on the head rows --------------------------------
        n_head = min(head_chunks * chunk, n_all)
        head = np.ascontiguousarray(panel[:n_head])
        ref = plain.models[:-(-n_head // chunk)]
        head_path = os.path.join(work.name, "head.npy")
        np.save(head_path, head)
        kill_dir = os.path.join(work.name, "kill")
        kill_inc = os.path.join(work.name, "kill-incidents")
        oom_out = os.path.join(work.name, "oom-coefs.npy")
        children.append(start_durable_child(
            _DURABLE_KILL_CHILD, head_path, dev, chunk,
            STS_DURABLE_JOURNAL=kill_dir, STS_INCIDENT_DIR=kill_inc))
        children.append(start_durable_child(
            _DURABLE_OOM_CHILD, head_path, dev, chunk,
            STS_DURABLE_OUT=oom_out))

        def case(fault=None, want=None, **extra):
            """One run over the head rows; ``want`` the models it must
            equal bit for bit (default: every head chunk's)."""
            c0 = counts()
            t0 = time.perf_counter()
            if fault is None:
                res = eng.stream_fit(head, "arima", **kw, **extra)
            else:
                with resilience.fault_injection(fault[0], **fault[1]):
                    res = eng.stream_fit(head, "arima", **kw, **extra)
            st = res.stats
            return {
                "seconds": time.perf_counter() - t0,
                "launches": delta(c0)["arma_lm_fit"],
                "models": len(res.models),
                "ranges": st["collected_ranges"],
                "failures": [f["kind"] for f in res.chunk_failures],
                "bitwise": _models_bitwise(
                    res.models, ref if want is None else want),
                **{k: st[k] for k in (
                    "journal_hits", "journal_commits", "journal_corrupt",
                    "degraded_chunks", "deadline_expired", "retry_attempts",
                    "recovered", "dead_chunks", "abandoned_workers")}}

        oom_j = os.path.join(work.name, "oom")
        r1 = case(("oom_chunk", dict(chunk_index=2)), journal=oom_j)
        r2 = case(journal=oom_j)
        row["oom_chunk"] = {"run": r1, "resume": r2}
        half = chunk // 2
        chk(r1["degraded_chunks"] == 1 and r1["bitwise"]
            and [2 * chunk, 2 * chunk + half] in r1["ranges"]
            and [2 * chunk + half, 3 * chunk] in r1["ranges"]
            and r1["launches"] == head_chunks + 1
            and r2["journal_hits"] == head_chunks
            and r2["journal_commits"] == 0 and r2["launches"] == 0
            and r2["bitwise"],
            f"durable_path oom_chunk: {row['oom_chunk']} (one chunk halved "
            f"into two {half}-lane sub-chunks, bitwise; the resume takes "
            f"them as one chunk)")

        # the fault hangs every attempt at the chunk, as the JAX engine
        # reads it: the retry waits out the abandoned worker (the backoff
        # outlasts the hang), hangs again and expires again
        try:
            r3 = case(("hang_chunk", dict(chunk_index=1, hang_s=hang_s)),
                      want=ref[:1] + ref[2:], deadline_s=deadline_s,
                      retry=BackoffPolicy(max_retries=1,
                                          base_delay_s=hang_s))
        finally:
            _join_chunk_workers()
        row["hang_chunk"] = dict(r3, deadline_s=deadline_s, hang_s=hang_s)
        chk(r3["deadline_expired"] == 2 and r3["retry_attempts"] == 1
            and r3["recovered"] == 0 and r3["dead_chunks"] == 1
            and r3["abandoned_workers"] == 2
            and r3["failures"] == ["deadline"]
            and r3["launches"] == head_chunks - 1 and r3["bitwise"],
            f"durable_path hang_chunk: {row['hang_chunk']} (two expiries, "
            f"one retry, one dead chunk, no abandoned worker fitted, the "
            f"other chunks bitwise)")

        cor_j = os.path.join(work.name, "corrupt")
        r4 = case(("corrupt_journal", dict(chunk_index=1)), journal=cor_j)
        r5 = case(journal=cor_j)
        row["corrupt_journal"] = {
            "run": r4, "resume": r5,
            "quarantined_files": sorted(os.listdir(
                os.path.join(cor_j, "quarantine")))}
        chk(r4["journal_commits"] == head_chunks
            and r5["journal_corrupt"] == 1
            and r5["journal_hits"] == head_chunks - 1
            and r5["journal_commits"] == 1 and r5["launches"] == 1
            and r5["bitwise"] and len(row["corrupt_journal"][
                "quarantined_files"]) == 3,
            f"durable_path corrupt_journal: {row['corrupt_journal']} (the "
            f"entry quarantined, one chunk refitted, bitwise)")

        # -- the kill -9 child and the resume here -------------------------
        kill = children[0]
        _, err = _wait_child(kill)
        markers = sorted(n for n in os.listdir(kill_dir)
                         if n.endswith(".ok")) \
            if os.path.isdir(kill_dir) else []
        incident = os.path.isdir(kill_inc) and any(
            "kill_after_chunk" in n for n in os.listdir(kill_inc))
        row["kill9"] = {"returncode": kill.returncode,
                        "markers": len(markers), "incident": incident}
        if kill.returncode == -9:
            r6 = case(journal=kill_dir)
            row["kill9"]["resume"] = r6
            ok = r6["journal_hits"] == 2 \
                and r6["journal_commits"] == head_chunks - 2 \
                and r6["launches"] == head_chunks - 2 and r6["bitwise"]
        else:
            ok = False
        chk(ok and len(markers) == 2 and incident,
            f"durable_path kill -9: {row['kill9']} (exit -9 with 2 markers "
            f"and its bundle; the resume restores 2 and refits "
            f"{head_chunks - 2}, bitwise; stderr {err[-600:]!r})")

        # -- the real OOM child ----------------------------------------------
        oom = children[1]
        out, err = _wait_child(oom)
        real = {"returncode": oom.returncode}
        if oom.returncode == 0:
            real.update(json.loads(out.strip().splitlines()[-1]))
            real["bitwise"] = _bitwise_equal(np.load(oom_out),
                                             _coef_rows(ref))
        row["real_oom"] = real
        chk(oom.returncode == 0 and real.get("degraded_chunks", 0) >= 1
            and real.get("dead_chunks") == 0 and real.get("bitwise"),
            f"durable_path real OOM: {real} (halved under the cap, no "
            f"raise, no dead chunk, bitwise; stderr {err[-600:]!r})")
        children = []

        # -- Holt-Winters: a corrupt entry refitted on resume ---------------
        n_hw = min(hw_chunks * chunk, hw_panel.shape[0])
        hw_head = np.ascontiguousarray(hw_panel[:n_hw])
        hkw = dict(chunk_size=chunk, period=HW_PERIOD, device=dev,
                   collect=True, journal=os.path.join(work.name, "hw"))
        c0 = counts()
        with resilience.fault_injection("corrupt_journal", chunk_index=1):
            h1 = eng.stream_fit(hw_head, "holt_winters", **hkw)
        h1_l = delta(c0)["hw_box_fit"]
        c0 = counts()
        h2 = eng.stream_fit(hw_head, "holt_winters", **hkw)
        h2_l = delta(c0)["hw_box_fit"]
        hw_same = all(_model_bitwise(a, b)
                      for a, b in zip(h2.models, h1.models))
        row["holt_winters"] = {
            "series": n_hw, "launches": h1_l, "resume_launches": h2_l,
            "resume_hits": h2.stats["journal_hits"],
            "resume_corrupt": h2.stats["journal_corrupt"],
            "resume_commits": h2.stats["journal_commits"],
            "bitwise": hw_same}
        chk(h1_l == hw_chunks and h2_l == 1
            and h2.stats["journal_corrupt"] == 1
            and h2.stats["journal_hits"] == hw_chunks - 1 and hw_same,
            f"durable_path holt_winters: {row['holt_winters']} (launches "
            f"= chunks refit, resumed bitwise)")

        # -- fit_long through the staged, journaled segment stream ----------
        series = long_series(long_obs, LONG_SEED, dev)
        lkw = dict(fused=False, journal=os.path.join(work.name, "long"),
                   warn=False, device=dev)
        c0 = counts()
        lf1 = longseries.fit_long(series, (1, 0, 1), **lkw)
        l1 = delta(c0)["arma_lm_fit"]
        c0 = counts()
        lf2 = longseries.fit_long(series, (1, 0, 1), **lkw)
        l2 = delta(c0)["arma_lm_fit"]
        ss1, ss2 = lf1.stream_stats, lf2.stream_stats
        row["fit_long"] = {
            "n_obs": int(long_obs), "chunks": ss1["n_chunks"],
            "launches": l1, "resume_launches": l2,
            "commits": ss1["journal_commits"],
            "resume_hits": ss2["journal_hits"],
            "bitwise": _bitwise_equal(lf1.coefficients.cpu().numpy(),
                                      lf2.coefficients.cpu().numpy())}
        chk(ss2["journal_hits"] == ss1["n_chunks"] == l1
            and ss2["journal_commits"] == 0 and l2 == 0
            and row["fit_long"]["bitwise"],
            f"durable_path fit_long: {row['fit_long']} (the second call "
            f"restores every chunk, combined coefficients bitwise)")

        # -- backtest_panel with one journal per candidate ------------------
        bt, _ = backtest_demo_panel(bt_series)
        grid = CandidateGrid(BT_GRID, horizons=BT_HORIZONS)
        bkw = dict(device=dev, journal=os.path.join(work.name, "bt"),
                   **BT_SCHEDULE)
        c0 = counts()
        rep1 = backtest_panel(bt, grid, **bkw)
        b1 = delta(c0)["arma_lm_fit"]
        c0 = counts()
        rep2 = backtest_panel(bt, grid, **bkw)
        b2 = delta(c0)["arma_lm_fit"]
        chunks = sum(s.get("n_chunks", 0) for s in rep1.stream_stats)
        row["backtest"] = {
            "shape": list(bt.shape), "candidates": len(grid),
            "chunks": chunks, "launches": b1, "resume_launches": b2,
            "commits": sum(s["journal_commits"] for s in rep1.stream_stats),
            "resume_hits": sum(s["journal_hits"]
                               for s in rep2.stream_stats),
            "bitwise": rep1.digest() == rep2.digest() and _bitwise_equal(
                rep1.champion, rep2.champion)}
        chk(row["backtest"]["resume_hits"] == chunks
            and row["backtest"]["commits"] == chunks and b2 == 0
            and row["backtest"]["bitwise"],
            f"durable_path backtest: {row['backtest']} (hits = the "
            f"candidates' chunks, champions and tables bitwise)")
    finally:
        for proc in children:
            proc.kill()
            proc.communicate()
        work.cleanup()

    # -- ops.decompose and ops.detect_anomalies, full width -----------------
    t0 = time.perf_counter()
    hw_dev = torch.from_numpy(hw_panel).to(dev)
    dec = ops.decompose(hw_dev, HW_PERIOD)
    dec_ms = _event_ms(lambda: ops.decompose(hw_dev, HW_PERIOD), 3)
    dec64 = ops.decompose(torch.from_numpy(
        hw_panel[:ref_rows].astype(np.float64)), HW_PERIOD)
    scale = np.abs(hw_panel[:ref_rows]).max(axis=1, keepdims=True)
    dec_err = {f: _lane_rel(getattr(dec, f)[:ref_rows].cpu().numpy(),
                            getattr(dec64, f).numpy(), scale)
               for f in dec._fields}
    del dec, hw_dev
    vals = torch.from_numpy(panel).to(dev)
    coefs = torch.from_numpy(_coef_rows(plain.models)).to(dev)
    model = arima.ARIMAModel(2, 1, 2, coefs, True)
    fitted = model.forecast(vals, 1)[..., :panel.shape[1]]
    an = ops.detect_anomalies(vals, fitted, conf=ANOM_CONF,
                              burn_in=ANOM_BURN)
    an_ms = _event_ms(lambda: ops.detect_anomalies(
        vals, fitted, conf=ANOM_CONF, burn_in=ANOM_BURN), 3)
    an64 = ops.detect_anomalies(
        torch.from_numpy(panel[:ref_rows].astype(np.float64)),
        fitted[:ref_rows].double().cpu(), conf=ANOM_CONF, burn_in=ANOM_BURN)
    s32 = an.score[:ref_rows].cpu().numpy()
    s64 = an64.score.numpy()
    sig64 = an64.sigma.numpy()
    z = float(an64.threshold_z.reshape(-1)[0])
    clear = np.abs(s64 - z) > DUR_Z_MARGIN
    flags_same = bool(np.array_equal(
        an.is_anomaly[:ref_rows].cpu().numpy()[clear],
        an64.is_anomaly.numpy()[clear]))
    an_err = {
        "score": _lane_rel(s32, s64, np.maximum(np.abs(s64), 1.0)),
        "sigma": _lane_rel(an.sigma[:ref_rows].cpu().numpy(), sig64,
                           np.abs(sig64)),
        "center": _lane_rel(an.center[:ref_rows].cpu().numpy(),
                            an64.center.numpy(), np.abs(sig64))}
    row["ops"] = {
        "decompose_shape": list(hw_panel.shape), "decompose_ms": dec_ms,
        "decompose_vs_f64": dec_err,
        "anomaly_shape": list(panel.shape), "anomaly_ms": an_ms,
        "anomaly_vs_f64": an_err, "flags_equal_off_threshold": flags_same,
        "flag_share": float(an.is_anomaly.float().mean()),
        "points_near_threshold": int((~clear).sum()),
        "seconds": time.perf_counter() - t0}
    del an, fitted, vals
    chk(max(dec_err.values()) <= DUR_RTOL and max(an_err.values())
        <= DUR_RTOL and flags_same,
        f"durable_path ops: {row['ops']} (within {DUR_RTOL:g} of the "
        f"float64 CPU run; flags equal off the threshold)")

    launches = counts()
    row["launches"] = launches
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    # the whole panel twice, the oom case (3 chunks and 2 halves), the
    # hang case (the 3 chunks that do not hang), the corrupt case and its
    # one refit, the kill -9 resume, fit_long's and the backtest's first
    # calls
    want_lm = 2 * n_chunks + (head_chunks + 1) + (head_chunks - 1) \
        + head_chunks + 1 \
        + (head_chunks - 2 if row.get("kill9", {}).get("resume") else 0) \
        + row["fit_long"]["launches"] + row["backtest"]["launches"]
    chk(launches["arma_lm_fit"] == want_lm
        and launches["hw_box_fit"] == hw_chunks + 1,
        f"durable_path launched arma_lm_fit {launches['arma_lm_fit']} "
        f"(want {want_lm}) and hw_box_fit {launches['hw_box_fit']} (want "
        f"{hw_chunks + 1})")
    chk(launches["arma_ne"] == 0 and launches["arma_css"] == 0
        and launches["hw_sse"] == 0,
        f"durable_path launched a one-pass kernel: {launches}")
    chk.raise_first()
    return row


OBS_HEAD_CHUNKS = 4        # the warm-up children's rows: 4 full chunks
OBS_SCRAPE_S = 0.05        # the scraper's period over the four routes
OBS_DEADLINE_S = 1.0       # the flight-recorder case's per-chunk deadline
OBS_HANG_S = 3.0           # ... and its injected hang
OBS_LM_ANNOTATION = "chip_smoke.arma_lm_fit_launch"

# the warm-up child: one fresh process streams the head rows, first
# warmed (warmup of the stream's chunk shape) or not (twice, unwarmed)
_OBS_WARM_CHILD = r"""
import json, os, time
import numpy as np
import torch
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.ops import arma_ne
v = np.load(os.environ["STS_OBS_HEAD"])
chunk = int(os.environ["STS_OBS_CHUNK"])
warm = os.environ["STS_OBS_WARM"] == "1"
dev = torch.device(os.environ["STS_OBS_DEVICE"])
eng = engine.FitEngine()
out = {"warm": warm}
if warm:
    out["warmup"] = eng.warmup(("arima",), [(chunk, v.shape[1])],
                               bucket=False, device=dev)
def stream():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = eng.stream_fit(v, "arima", p=2, d=1, q=2, chunk_size=chunk,
                         collect=True, device=dev)
    return res, time.perf_counter() - t0
res, s = stream()
out["first_s"] = s
out["first_series_per_s"] = v.shape[0] / s
def cat(field):
    return torch.cat([getattr(m.diagnostics if field != "coefficients"
                              else m, field) for m in res.models]).numpy()
np.savez(os.environ["STS_OBS_OUT"], **{f: cat(f) for f in (
    "coefficients", "converged", "n_iter", "fun")})
if not warm:
    _, s2 = stream()
    out["second_s"] = s2
    out["second_series_per_s"] = v.shape[0] / s2
out["cache_stats"] = eng.cache_stats()
out["arma_lm_fit_launches"] = arma_ne.fit_css_lm.launches
print(json.dumps(out))
"""

# the Prometheus text exposition grammar (format 0.0.4) the JAX
# package's telemetry tests hold the exporter to
_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_PROM_HELP = re.compile(rf"^# HELP {_PROM_NAME} [^\n]*$")
_PROM_TYPE = re.compile(
    rf"^# TYPE ({_PROM_NAME}) (counter|gauge|summary|histogram|untyped)$")
_PROM_LABELS = (r'\{[a-zA-Z_][a-zA-Z0-9_]*="[^"\\\n]*"'
                r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"\\\n]*")*\}')
_PROM_VALUE = (r"(-?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?|[+-]?[Ii]nf"
               r"|[Nn]a[Nn])")
_PROM_SAMPLE = re.compile(
    rf"^({_PROM_NAME})({_PROM_LABELS})? {_PROM_VALUE}$")


def prometheus_errors(text: str) -> list:
    """What in ``text`` breaks the exposition grammar or the summary
    type's contract (each summary family emits ``_sum`` and
    ``_count``); empty when it holds."""
    if text == "":
        return []
    if not text.endswith("\n"):
        return ["no trailing newline"]
    errors, declared, sampled = [], {}, set()
    for line in text[:-1].split("\n"):
        if line.startswith("# HELP "):
            if not _PROM_HELP.match(line):
                errors.append(f"bad HELP line {line!r}")
        elif line.startswith("# TYPE "):
            m = _PROM_TYPE.match(line)
            if not m or m.group(1) in declared:
                errors.append(f"bad or duplicate TYPE line {line!r}")
            else:
                declared[m.group(1)] = m.group(2)
        else:
            m = _PROM_SAMPLE.match(line)
            if not m:
                errors.append(f"bad sample line {line!r}")
            else:
                sampled.add(m.group(1))
    for name, kind in declared.items():
        if kind == "summary" and not {f"{name}_sum",
                                      f"{name}_count"} <= sampled:
            errors.append(f"summary {name} lacks _sum or _count")
    for name in sampled:
        if name not in declared and not any(
                name == f"{d}{sfx}" and declared[d] == "summary"
                for d in declared for sfx in ("_sum", "_count")):
            errors.append(f"sample {name} has no TYPE")
    return errors


def _http_get(url: str):
    """``(status, body)`` of a GET, an HTTP error's included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Scraper:
    """A thread that GETs the exporter's four routes every ``period``
    seconds until stopped, keeping each answer's status and whether its
    body parses (Prometheus grammar for ``/metrics``, JSON for the
    rest)."""

    ROUTES = ("/metrics", "/snapshot.json", "/healthz", "/trace.json")

    def __init__(self, url: str, period: float):
        import threading

        self.url, self.period = url, period
        self.answers = []
        self.bytes = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chip-smoke-scraper")

    def _loop(self):
        while not self._stop.is_set():
            for route in self.ROUTES:
                try:
                    status, body = _http_get(self.url + route)
                    self.bytes[route] = max(self.bytes.get(route, 0),
                                            len(body))
                    if route == "/metrics":
                        errors = prometheus_errors(body)
                    else:
                        json.loads(body)
                        errors = []
                except Exception as e:  # noqa: BLE001 — reported below
                    status, errors = None, [f"{type(e).__name__}: {e}"]
                self.answers.append((route, status, errors))
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(60)

    def summary(self) -> dict:
        by = {r: {"scrapes": 0, "not_200": 0, "unparsed": 0}
              for r in self.ROUTES}
        first_error = None
        for route, status, errors in self.answers:
            by[route]["scrapes"] += 1
            by[route]["not_200"] += status != 200
            by[route]["unparsed"] += bool(errors)
            if errors and first_error is None:
                first_error = f"{route}: {errors[0]}"
        return {"by_route": by, "max_bytes": dict(self.bytes),
                "first_error": first_error}


def _obs_child(head_path: str, out_path: str, chunk: int, warm: bool,
               env: dict, dev) -> dict:
    """Run :data:`_OBS_WARM_CHILD` in a fresh process; its report."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _OBS_WARM_CHILD], capture_output=True,
        text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(
            __file__)),
        env=dict(env, STS_OBS_HEAD=head_path, STS_OBS_OUT=out_path,
                 STS_OBS_CHUNK=str(chunk), STS_OBS_DEVICE=str(dev),
                 STS_OBS_WARM="1" if warm else "0"))
    check(out.returncode == 0,
          f"obs_path warm-up child (warm={warm}) exited "
          f"{out.returncode}: {out.stderr[-3000:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    rep["process_s"] = time.perf_counter() - t0
    return rep


def phase_obs_path(panel, dev, smi, chunk=CHUNK,
                   head_chunks=OBS_HEAD_CHUNKS):
    """The compile tier and the host observability planes on the card
    (module docstring, 30)."""
    import shutil
    import tempfile

    import torch

    from spark_timeseries_tpu_torch import _build
    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse
    from spark_timeseries_tpu_torch.utils import (flightrec, metrics,
                                                  observability,
                                                  resilience, telemetry,
                                                  tracing)

    wrappers = {"arma_lm_fit": arma_ne.fit_css_lm,
                "arma_ne": arma_ne.normal_equations,
                "arma_css": arma_ne.css_cost,
                "hw_box_fit": hw_sse.box_fit,
                "hw_sse": hw_sse.value_and_grad}
    for w in wrappers.values():
        w.launches = 0
    row = {"phase": "obs_path", "nvidia_smi": smi}
    chk = _Checks()
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=scratch)
    env = {k: v for k, v in os.environ.items()
           if k not in ("STS_COMPILE_CACHE", "STS_TELEMETRY_PORT",
                        "STS_INCIDENT_DIR", "STS_TRACE")}
    n_all = panel.shape[0]
    n_chunks = -(-n_all // chunk)
    kw = dict(chunk_size=chunk, p=2, d=1, q=2, device=dev)
    child_launches = {"arma_lm_fit": 0, "hw_box_fit": 0}
    children = []
    lm_call = arma_ne._lm_call
    try:
        # -- the kernel build cache: a cold and a warm CLI process ---------
        cache = os.path.join(work.name, "kernels")
        shutil.copytree(_build.BUILD_DIR, cache,
                        ignore=shutil.ignore_patterns("hw_sse-*", "*.tmp*"))
        cli = [sys.executable, "-m", "spark_timeseries_tpu_torch.engine",
               "--families", "arima,holt_winters",
               "--shapes", f"{chunk}x{panel.shape[1]}", "--serving",
               "--cache-dir", cache, "--device", str(dev)]
        row["cli"] = {}

        def cli_done(name, proc, t0):
            stdout, stderr = proc.communicate(timeout=900)
            check(proc.returncode == 0,
                  f"obs_path: the {name} engine CLI exited "
                  f"{proc.returncode}: {stderr[-3000:]}")
            rep = json.loads(stdout)
            k = rep["kernels"]
            row["cli"][name] = {
                "seconds": time.perf_counter() - t0,
                "warmup_wall_s": rep["wall_s"], "built": rep["built"],
                "executables": rep["executables"],
                "serving": [r["bucket"] for r in rep["serving"]],
                "kernels": k}
            for kern in child_launches:
                child_launches[kern] += k["launches"][kern]
            chk(k["launches"]["arma_lm_fit"] == 2
                and k["launches"]["hw_box_fit"] == 1
                and not any(k["launches"][n] for n in ("arma_ne",
                                                       "arma_css",
                                                       "hw_sse")),
                f"obs_path {name} CLI launches {k['launches']} (want one "
                f"arma_lm_fit per ARIMA variant, one hw_box_fit)")

        # the cold process spends most of its time in one nvcc process
        # on the host; the warm-up children (below) use the card meanwhile
        t_cold = time.perf_counter()
        cold_proc = subprocess.Popen(cli, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     cwd=root, env=env)
        children.append(cold_proc)

        # -- warm-up: a first stream in a fresh process, warmed or not -----
        head = np.ascontiguousarray(panel[:head_chunks * chunk])
        head_path = os.path.join(work.name, "head.npy")
        np.save(head_path, head)
        outs = {w: os.path.join(work.name, f"coefs-{w}.npz")
                for w in ("cold", "warm")}
        cold_rep = _obs_child(head_path, outs["cold"], chunk, False, env,
                              dev)
        warm_rep = _obs_child(head_path, outs["warm"], chunk, True, env,
                              dev)
        cli_done("cold", cold_proc, t_cold)
        t0 = time.perf_counter()
        warm_proc = subprocess.Popen(cli, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     cwd=root, env=env)
        children.append(warm_proc)
        cli_done("warm", warm_proc, t0)
        cold, warm = row["cli"]["cold"]["kernels"], \
            row["cli"]["warm"]["kernels"]
        chk(cold["builds"] == 1 and cold["cache_hits"] == 1
            and warm["builds"] == 0 and warm["cache_hits"] == 2
            and any(n.startswith("hw_sse-") for n in os.listdir(cache)),
            f"obs_path build cache: cold {cold}, warm {warm} (the cold "
            f"process builds hw_sse alone, the warm one builds nothing)")

        a, b = np.load(outs["cold"]), np.load(outs["warm"])
        bitwise = all(_bitwise_equal(a[f], b[f]) for f in a.files)
        child_launches["arma_lm_fit"] += cold_rep["arma_lm_fit_launches"] \
            + warm_rep["arma_lm_fit_launches"]
        row["warmup"] = {
            "series": int(head.shape[0]), "unwarmed": cold_rep,
            "warmed": {k: v for k, v in warm_rep.items() if k != "warmup"},
            "warmup_report": {k: warm_rep["warmup"][k] for k in (
                "wall_s", "platform", "executables", "cache_hits",
                "cache_misses")},
            "first_stream_speedup": warm_rep["first_series_per_s"]
            / cold_rep["first_series_per_s"],
            "bitwise": bitwise}
        chk(bitwise, "obs_path: the warmed first stream's models are not "
            "bitwise the unwarmed one's")
        chk(warm_rep["cache_stats"] == {"executables": 2,
                                        "cache_hits": head_chunks,
                                        "cache_misses": 2}
            and cold_rep["cache_stats"] == {
                "executables": 1, "cache_hits": 2 * head_chunks - 1,
                "cache_misses": 1}
            and warm_rep["arma_lm_fit_launches"] == head_chunks + 2
            and cold_rep["arma_lm_fit_launches"] == 2 * head_chunks,
            f"obs_path warm-up children: {row['warmup']}")

        # -- the exporter during the north-star stream, in turns -----------
        eng = FitEngine()
        eng.stream_fit(panel[:chunk], "arima", **kw)        # warm
        telemetry.stop()
        srv = telemetry.start(port=0)
        runs, scrape, trace_window = [], None, None
        for i, scraped in enumerate((False, True, True, False)):
            label = f"obs-{i}"
            c0 = arma_ne.fit_css_lm.launches
            ctx = _Scraper(srv.url, OBS_SCRAPE_S) if scraped \
                else contextlib.nullcontext()
            with ctx as sc:
                _sync(dev)
                t_ring = time.perf_counter()
                t0 = time.perf_counter()
                res = eng.stream_fit(panel, "arima", job_label=label, **kw)
                secs = time.perf_counter() - t0
            runs.append({"scraped": scraped, "seconds": secs,
                         "series_per_s": n_all / secs,
                         "arma_lm_fit": arma_ne.fit_css_lm.launches - c0,
                         "chunks": res.n_chunks})
            if i == 1:
                scrape = sc.summary()
                trace_window = (t_ring, time.perf_counter())
        snap = json.loads(_http_get(srv.url + "/snapshot.json")[1])
        hz_status, _ = _http_get(srv.url + "/healthz")
        job = [j for j in snap["recent_jobs"] if j["family"] == "obs-1"]
        telemetry.stop()
        plain = [r["series_per_s"] for r in runs if not r["scraped"]]
        scraped_rates = [r["series_per_s"] for r in runs if r["scraped"]]
        row["exporter"] = {
            "runs": runs, "scrape": scrape, "healthz_status": hz_status,
            "job": job[0] if job else None,
            "scraped_over_plain": float(np.median(scraped_rates)
                                        / np.median(plain)),
            "scrape_s": metrics.snapshot()["histograms"].get(
                "telemetry.scrape_s"),
            "snapshot_kernels": snap["kernels"]}
        chk(all(r["arma_lm_fit"] == n_chunks for r in runs),
            f"obs_path exporter runs launched {[r['arma_lm_fit'] for r in runs]}"
            f" arma_lm_fit (want {n_chunks} each)")
        by = scrape["by_route"]
        chk(all(v["scrapes"] >= 1 and v["not_200"] == 0
                and v["unparsed"] == 0 for v in by.values())
            and hz_status == 200 and job
            and job[0]["status"] == "done"
            and job[0]["chunks_done"] == n_chunks,
            f"obs_path exporter: {row['exporter']}")

        # -- the stream's host-side span breakdown and a profiled chunk ----
        evs = [e for e in metrics.trace_events()
               if trace_window[0] <= e["ts"] <= trace_window[1]]
        out_dir = os.path.join(root, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        trace_path = tracing.write_trace(
            os.path.join(out_dir, "obs_path_trace.json"), events=evs)
        report = tracing.self_time_report(10, evs)
        print("obs_path self_time_report(10):", json.dumps(report),
              flush=True)
        row["trace"] = {"path": os.path.relpath(trace_path, root),
                        "bytes": os.path.getsize(trace_path),
                        "events": len(evs), "self_times": report}
        chk(any(e["name"].endswith("engine.dispatch") for e in evs),
            "obs_path: the stream's trace holds no engine.dispatch span")

        def annotated(*args, **kwargs):
            with torch.profiler.record_function(OBS_LM_ANNOTATION):
                return lm_call(*args, **kwargs)

        arma_ne._lm_call = annotated
        prof_dir = os.path.join(work.name, "profile")
        c0 = arma_ne.fit_css_lm.launches
        with observability.profile(prof_dir) as prof:
            eng.stream_fit(panel[:chunk], "arima", **kw)
        arma_ne._lm_call = lm_call
        kevs = list(prof.profiler.kineto_results.events())
        # the range on the host's timeline (the profiler also draws it
        # on the card's, over the card's span of the work)
        spans = [(e.start_ns(), e.end_ns()) for e in kevs
                 if e.name() == OBS_LM_ANNOTATION
                 and e.device_type() == torch.autograd.DeviceType.CPU]
        runtime = [e for e in kevs if _ENQUEUE.match(e.name())]
        in_span = [e.name() for e in runtime
                   if any(a <= e.start_ns() <= b for a, b in spans)]
        files = os.listdir(prof_dir)
        row["profile"] = {
            "trace_files": files,
            "trace_bytes": sum(os.path.getsize(os.path.join(prof_dir, f))
                               for f in files),
            "annotations": len(spans), "runtime_ops_in_launch": in_span,
            "runtime_ops": len(runtime),
            "device_records": sum(
                1 for e in kevs
                if e.device_type() == torch.autograd.DeviceType.CUDA),
            "device_lm_fit_records": sum(
                1 for e in kevs if "arma_lm_fit" in e.name()
                and e.device_type() == torch.autograd.DeviceType.CUDA),
            "arma_lm_fit": arma_ne.fit_css_lm.launches - c0}
        chk(len(files) == 1 and row["profile"]["trace_bytes"] > 0
            and len(spans) == 1 and len(in_span) == 1
            and row["profile"]["arma_lm_fit"] == 1,
            f"obs_path profile: {row['profile']} (one trace file, one "
            f"arma_lm_fit launch counted by its runtime record)")

        # -- a dead chunk's incident bundle carries the trace --------------
        inc_dir = os.path.join(work.name, "incidents")
        flightrec.configure(inc_dir)
        try:
            with resilience.fault_injection("hang_chunk", chunk_index=0,
                                            hang_s=OBS_HANG_S):
                hung = eng.stream_fit(panel[:2 * chunk], "arima",
                                      deadline_s=OBS_DEADLINE_S, retry=0,
                                      **kw)
        finally:
            flightrec.configure(None)
            _join_chunk_workers()
        index = flightrec.list_incidents(inc_dir)
        dead = [e for e in index if e["kind"] == "chunk_dead"]
        bundle = flightrec.load_incident(dead[0]["path"]) if dead else {}
        tev = bundle.get("trace", {}).get("traceEvents", [])
        leaves = sorted({e["name"].rsplit("/", 1)[-1] for e in tev
                         if e.get("ph") == "X"})
        row["flightrec"] = {
            "kinds": sorted(e["kind"] for e in index),
            "dead_chunks": hung.stats["dead_chunks"],
            "schema_problems": flightrec.validate_bundle(bundle),
            "trace_events": len(tev), "span_leaves": leaves}
        chk(len(dead) == 1 and not row["flightrec"]["schema_problems"]
            and {"engine.stage", "engine.dispatch", "engine.collect",
                 "engine.publish"} <= set(leaves),
            f"obs_path flightrec: {row['flightrec']} (a schema-valid "
            f"chunk_dead bundle whose trace holds the stream's spans)")
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        arma_ne._lm_call = lm_call
        telemetry.stop()
        work.cleanup()

    launches = {k: w.launches for k, w in wrappers.items()}
    row["launches"] = launches
    row["child_launches"] = child_launches
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    # the warm-up stream, the four north-star streams, the profiled chunk
    # and the hung stream's other chunk
    want_lm = 1 + 4 * n_chunks + 1 + 1
    chk(launches["arma_lm_fit"] == want_lm and launches["hw_box_fit"] == 0
        and not any(launches[k] for k in ("arma_ne", "arma_css", "hw_sse")),
        f"obs_path launched {launches} here (want arma_lm_fit {want_lm} "
        f"and nothing else)")
    chk.raise_first()
    return row


def _join_chunk_workers(timeout_s=60.0) -> None:
    """Wait for every abandoned chunk worker of the engine's watchdog."""
    import threading

    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if not any(t.name.startswith("sts-chunk-")
                   for t in threading.enumerate()):
            return
        time.sleep(0.05)
    check(False, "an abandoned chunk worker outlived its hang")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic panel and kernel inputs")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "card", file=sys.stderr)
        return 1
    from spark_timeseries_tpu_torch import _build
    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse

    os.makedirs(os.path.dirname(ROWS_FILE), exist_ok=True)
    open(ROWS_FILE, "w").close()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    libs = _build.build_all()
    arma_ne._kernel_fn()
    arma_ne._css_kernel_fn()
    arma_ne._rows_fns()
    arma_ne._lm_fns()
    hw_sse._kernel_fn()
    hw_sse._rows_fns()
    hw_sse._box_fns()
    build_s = time.perf_counter() - t0
    from spark_timeseries_tpu_torch import io
    t0 = time.perf_counter()
    check(io.fastcsv() is not None,
          "g++ did not build the CSV codec csrc/fastcsv.cpp")
    emit({"phase": "build", "seconds": build_s,
          "libraries": [str(p.name) for p in libs],
          "csv_codec_seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    hw_panel = synthetic_hw_panel(N_SERIES, HW_N_OBS, HW_PERIOD, args.seed)
    refit = start_hw_refit(hw_panel)
    auto_panel = synthetic_arima_panel(AUTO_N_SERIES, N_OBS, AUTO_SEED)
    auto_ref = start_auto_ref(auto_panel)
    try:
        return _run(args, dev, smi, hw_panel, refit, auto_panel, auto_ref,
                    t0)
    except BaseException:
        print_summary()         # the phases that passed before the failure
        raise
    finally:
        for pool, _ in (refit, auto_ref):
            pool.terminate()
            pool.join()


def _run(args, dev, smi, hw_panel, refit, auto_panel, auto_ref,
         t0) -> int:
    import torch

    panel = synthetic_arima_panel(N_SERIES, N_OBS, args.seed)
    emit({"phase": "panel", "shape": list(panel.shape),
          "dtype": str(panel.dtype), "hw_shape": list(hw_panel.shape),
          "seconds": time.perf_counter() - t0})

    rows, max_abs, tm_max_abs = phase_kernel_vs_plain(panel, args.seed, dev)
    emit({"phase": "kernel_vs_plain", "cases": rows})

    from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse
    paths = ComparisonLaunches(arma_ne, hw_sse)
    main_row, lm_launches, arima_model = paths.run("main_path",
                                                   phase_main_path, panel,
                                                   dev)
    emit(main_row)

    lm_chunk = first_chunk_init(panel, dev)
    timing = phase_timing(panel, args.seed, dev, lm_chunk)
    emit(timing)

    lm_row = phase_lm_fit_vs_route(lm_chunk, timing["kernel_ms"], dev)
    del lm_chunk

    css_rows, css_max_abs, css_tm_max_abs = phase_css_cost_vs_plain(
        panel, args.seed, dev)
    emit({"phase": "css_cost_vs_plain", "cases": css_rows})

    hw_rows, hw_max_abs, hw_tm_max_abs = phase_hw_kernel_vs_plain(
        hw_panel, args.seed, dev)
    emit({"phase": "hw_kernel_vs_plain", "cases": hw_rows})

    hw_row, hw_launches, css_launches = paths.run(
        "hw_path", phase_hw_path, hw_panel, panel, arima_model, refit, dev)
    emit(hw_row)

    hw_timing = phase_hw_timing(hw_panel, panel, args.seed, dev)
    emit(hw_timing)

    fit_row = phase_hw_fit_vs_solver(hw_panel, hw_timing["kernel_ms"], dev)

    auto_row, grid_launches, screen = paths.run(
        "auto_fit_path", phase_auto_fit_path, auto_panel, auto_ref, dev)
    grid_row = phase_auto_grid_vs_route(screen, dev)
    del screen

    vol_ref = start_vol_ref(args.seed)
    try:
        panel_row = paths.run("panel_path", phase_panel_path, panel,
                              auto_panel, args.seed, dev)

        res_row = paths.run("resilient_path", phase_resilient_path, panel,
                            args.seed, dev)
        surf_row = paths.run("arima_surface", phase_arima_surface, panel,
                             args.seed, dev)

        # the slice-9 paths, each driven with the counts set to 0 just
        # before it and read just after
        paths.run("vol_path", phase_vol_path, args.seed, dev, vol_ref)
    finally:
        vol_ref[0].terminate()
        vol_ref[0].join()
    # the slice-10 float64 CPU references run while the card works on
    # the next phases
    s10_ref = start_slice10_ref(panel, args.seed)
    try:
        paths.run("ewma_path", phase_ewma_path, args.seed, dev)
        hwr_row = paths.run("hw_resilient_path", phase_hw_resilient_path,
                            hw_panel, hw_row["converged_pct"], args.seed,
                            dev)
        cgd_row = paths.run("css_cgd_path", phase_css_cgd_path, panel, dev)
        # the slice-10 paths, each driven with the counts set to 0 just
        # before it and read just after
        paths.run("regarima_path", phase_regarima_path, args.seed, dev)
        arx_row = paths.run("arimax_path", phase_arimax_path, panel,
                            args.seed, dev, s10_ref)
        exact_row = paths.run("exact_path", phase_exact_path, panel, dev,
                              s10_ref)
    finally:
        s10_ref[0].terminate()
        s10_ref[0].join()
    # slice 12: the online serving tier
    serv_row = paths.run("serving_path", phase_serving_path, panel,
                         hw_panel, dev)
    serv = serv_row["launches"]
    # slice 11: the series-major one-pass kernels at the widths the paths
    # above gave them
    rows_row = phase_ne_rows_timing(
        panel, args.seed, dev,
        [cgd_row["arma_ne_widths"], arx_row["resilient_arma_ne_widths"],
         surf_row["widths"]["arma_ne"]], [surf_row["widths"]["arma_css"]])
    # slice 13: the long-series tier and rolling-origin backtesting, each
    # driven with the counts set to 0 just before it and read just after;
    # after ne_rows_timing, whose device-time medians need the profiler's
    # device records, which a process stops receiving in full once it has
    # gone ~45 s without a profiler session (_profile_ops)
    long_row = paths.run("long_path", phase_long_path, dev)
    bt_row = paths.run("backtest_path", phase_backtest_path, dev)
    lng, btl = long_row["launches"], bt_row["launches"]
    # slice 14: the fleet, driven with the counts set to 0 just before it
    # and read just after
    flt = paths.run("fleet_path", phase_fleet_path, panel, hw_panel, dev,
                    smi)["launches"]
    # the durability tier and the ops, driven with the counts set to 0
    # just before it and read just after
    dur = paths.run("durable_path", phase_durable_path, panel, hw_panel,
                    dev, smi)["launches"]
    # the compile tier and the host observability planes, driven with
    # the counts set to 0 just before it and read just after; its child
    # processes report their own launches
    obs_row = paths.run("obs_path", phase_obs_path, panel, dev, smi)
    obs = {k: obs_row["launches"][k] + obs_row["child_launches"].get(k, 0)
           for k in obs_row["launches"]}
    surf = surf_row["launches"]
    # the auto-order stage's launches are the grid row's (its screen and
    # refine, as on the auto-fit path); the rest the LM-fit row's
    res_grid = sum(by.get("auto_order", 0)
                   for by in res_row["lm_fit_launches_by_stage_per_chunk"])
    res_lm = res_row["arma_lm_fit_launches"] - res_grid

    css = hw_timing["css"][0]       # the main path's order, (2,1,2)+c
    emit({"kernels": [{
        "name": "arma_lm_fit", "route": "cuda",
        "source": "spark_timeseries_tpu_torch/csrc/arma_ne.cuh",
        "replaces": "spark_timeseries_tpu/ops/pallas_arma.py:229",
        "replaces_solver": "spark_timeseries_tpu/ops/pallas_arma.py:463 "
                           "(fit_css_lm)",
        "launches": lm_launches + panel_row["arma_lm_fit_launches"]
        + res_lm + surf["arma_lm_fit"] + arx_row["arma_lm_fit_launches"]
        + arx_row["resilient_arma_lm_fit_launches"]
        + exact_row["arma_lm_fit_launches"]
        + serv_row["arma_lm_fit_launches"] + lng["arma_lm_fit"]
        + btl["arma_lm_fit"] + flt["arma_lm_fit"] + dur["arma_lm_fit"]
        + obs["arma_lm_fit"],
        "launches_by_path": {
            "main_path": lm_launches,
            "panel_path": panel_row["arma_lm_fit_launches"],
            "resilient_path": res_lm,
            "arima_surface": surf["arma_lm_fit"],
            "arimax_path": arx_row["arma_lm_fit_launches"],
            "arimax_path_resilient":
                arx_row["resilient_arma_lm_fit_launches"],
            "exact_path": exact_row["arma_lm_fit_launches"],
            "serving_path": serv_row["arma_lm_fit_launches"],
            "long_path": lng["arma_lm_fit"],
            "backtest_path": btl["arma_lm_fit"],
            "fleet_path": flt["arma_lm_fit"],
            "durable_path": dur["arma_lm_fit"],
            "obs_path": obs["arma_lm_fit"]},
        "long_path_launch": {
            k: long_row["lm_fit"][k] for k in (
                "lanes", "n_obs", "lm_fit_ms", "bound_ms", "bound_by",
                "plain_ms", "plain_iterations", "vs_plain_fun_within",
                "vs_plain_fun_max_rel_gap", "vs_plain_max_abs_x")},
        # few lanes at the other windows the slice-13 paths give it
        "long_windows_vs_plain": [
            {"where": where, **{k: r[k] for k in (
                "lanes", "n_obs", "order", "fun_rtol", "fun_within",
                "fun_max_rel_gap", "max_abs_x")}}
            for where, r in (
                ("long_path 10⁸", long_row["lm_fit_vs_plain"][
                    "hundred_million"]),
                ("long_path arima.fit_long", long_row["lm_fit_vs_plain"][
                    "arima_fit_long"]),
                ("backtest_path wide", bt_row["lm_fit_vs_plain"]))],
        # lanes stopped by the iteration cap end anywhere along a ridge
        "max_abs_err": lm_row["vs_plain_max_abs_x_same_iter_converged"],
        "ms": lm_row["lm_fit_ms"], "plain_ms": lm_row["plain_ms"],
        "plain_lanes": lm_row["plain_lanes"],
        "bound_ms": lm_row["bound_ms"], "bound_by": lm_row["bound_by"],
        "library_ms": None}, {
        "name": "arma_ne", "route": "cuda",
        "kernel": "arma_ne_rows_kernel",
        "source": "spark_timeseries_tpu_torch/csrc/arma_ne_rows.cuh",
        "replaces": "spark_timeseries_tpu/ops/pallas_arma.py:229",
        "launches": main_row["normal_equations_launches"]
        + auto_row["arma_ne_launches"] + panel_row["arma_ne_launches"]
        + res_row["arma_ne_launches"] + surf["arma_ne"]
        + cgd_row["arma_ne_launches"] + arx_row["arma_ne_launches"]
        + arx_row["resilient_arma_ne_launches"]
        + arx_row["methods_arma_ne_launches"]
        + exact_row["arma_ne_launches"] + serv["arma_ne"]
        + lng["arma_ne"] + btl["arma_ne"] + flt["arma_ne"] + dur["arma_ne"],
        "launches_by_path": {
            "main_path": main_row["normal_equations_launches"],
            "auto_fit_path": auto_row["arma_ne_launches"],
            "panel_path": panel_row["arma_ne_launches"],
            "resilient_path": res_row["arma_ne_launches"],
            "arima_surface": surf["arma_ne"],
            "css_cgd_path": cgd_row["arma_ne_launches"],
            "arimax_path": arx_row["arma_ne_launches"],
            "arimax_path_resilient": arx_row["resilient_arma_ne_launches"],
            "arimax_methods": arx_row["methods_arma_ne_launches"],
            "exact_path": exact_row["arma_ne_launches"],
            "serving_path": serv["arma_ne"],
            "long_path": lng["arma_ne"], "backtest_path": btl["arma_ne"],
            "fleet_path": flt["arma_ne"], "durable_path": dur["arma_ne"]},
        "route_launches": lm_row["route_arma_ne_launches"]
        + arx_row["route_arma_ne_launches"],
        "launch_widths": {
            "css_cgd_path": cgd_row["arma_ne_widths"],
            "arimax_path_resilient": arx_row["resilient_arma_ne_widths"],
            "arima_surface": surf_row["widths"]["arma_ne"]},
        "by_width": [{"S": r["S"], "ragged": r["ragged"],
                      "ms": r["ms"]["ne_kernel"]["new"],
                      "device_ms": r["ms"]["ne_kernel"]["new_device"],
                      "time_major_ms": r["ms"]["ne_kernel"]["old"],
                      "time_major_device_ms":
                          r["ms"]["ne_kernel"]["old_device"],
                      "bound_ms": r["ne_bound_ms"]}
                     for r in rows_row["rows"]],
        "max_abs_err": max_abs,
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_us"] / 1e3,
        "bound_by": timing["bound_by"], "library_ms": None}, {
        "name": "arma_css", "route": "cuda",
        "kernel": "arma_css_rows_kernel",
        "source": "spark_timeseries_tpu_torch/csrc/arma_ne.sse.cu",
        "replaces": "docs/experiments/arma_pallas.py:67",
        "launches": css_launches + res_row["arma_css_launches"]
        + surf["arma_css"] + arx_row["arma_css_launches"]
        + arx_row["methods_arma_css_launches"] + serv["arma_css"]
        + lng["arma_css"] + btl["arma_css"] + flt["arma_css"]
        + dur["arma_css"],
        "launches_by_path": {
            "hw_path": css_launches,
            "resilient_path": res_row["arma_css_launches"],
            "arima_surface": surf["arma_css"],
            "arimax_path": arx_row["arma_css_launches"],
            "arimax_methods": arx_row["methods_arma_css_launches"],
            "serving_path": serv["arma_css"],
            "long_path": lng["arma_css"], "backtest_path": btl["arma_css"],
            "fleet_path": flt["arma_css"], "durable_path": dur["arma_css"]},
        "launch_widths": {"arima_surface": surf_row["widths"]["arma_css"]},
        "by_width": [{"S": r["S"], "ragged": r["ragged"],
                      "ms": r["ms"]["css_kernel"]["new"],
                      "device_ms": r["ms"]["css_kernel"]["new_device"],
                      "time_major_ms": r["ms"]["css_kernel"]["old"],
                      "time_major_device_ms":
                          r["ms"]["css_kernel"]["old_device"],
                      "bound_ms": r["css_bound_ms"]}
                     for r in rows_row["rows"]],
        "max_abs_err": css_max_abs,
        "ms": css["kernel_ms"], "plain_ms": css["plain_ms"],
        "bound_ms": css["bound_us"] / 1e3,
        "bound_by": css["bound_by"], "library_ms": None}, {
        # the time-major kernels the two above replaced, kept as their
        # comparison (ne_rows_timing: bit for bit): their launches on the
        # paths (checked to be 0 below), their errors against the same
        # plain pass, and the plain pass of their own operands
        "name": "arma_ne_time_major", "route": "cuda",
        "kernel": "arma_ne_kernel",
        "source": "spark_timeseries_tpu_torch/csrc/arma_ne.cuh",
        "replaces": "spark_timeseries_tpu/ops/pallas_arma.py:229",
        "launches": paths.total["arma_ne_time_major"],
        "launches_by_path": paths.by_path["arma_ne_time_major"],
        "comparison_only": True,
        "max_abs_err": tm_max_abs,
        "ms": timing["time_major_kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["time_major_bound_us"] / 1e3,
        "bound_by": timing["bound_by"], "library_ms": None}, {
        "name": "arma_css_time_major", "route": "cuda",
        "kernel": "arma_css_kernel",
        "source": "spark_timeseries_tpu_torch/csrc/arma_ne.cu",
        "replaces": "docs/experiments/arma_pallas.py:67",
        "launches": paths.total["arma_css_time_major"],
        "launches_by_path": paths.by_path["arma_css_time_major"],
        "comparison_only": True,
        "max_abs_err": css_tm_max_abs,
        "ms": css["time_major_kernel_ms"], "plain_ms": css["plain_ms"],
        "bound_ms": css["bound_us"] / 1e3,
        "bound_by": css["bound_by"], "library_ms": None}, {
        "name": "hw_sse", "route": "cuda",
        "kernel": "hw_sse_rows_kernel",
        "source": "spark_timeseries_tpu_torch/csrc/hw_sse.rows.cu",
        "replaces": "docs/experiments/hw_pallas.py:61",
        "launches": hw_row["hw_sse_launches"]
        + hwr_row["hw_sse_launches"] + serv["hw_sse"] + flt["hw_sse"]
        + dur["hw_sse"],
        "launches_by_path": {
            "hw_path": hw_row["hw_sse_launches"],
            "hw_resilient_path": hwr_row["hw_sse_launches"],
            "serving_path": serv["hw_sse"], "fleet_path": flt["hw_sse"],
            "durable_path": dur["hw_sse"]},
        "route_launches": fit_row["solver_route_hw_sse_launches"]
        + hwr_row["restart_vs_route"]["route_hw_sse_launches"],
        "by_case": [{k: c[k] for k in (
            "case", "kernel_ms", "device_ms", "call_ms", "bound_us",
            "bound_by", "share_of_bound", "device_share_of_bound")}
            for c in hw_timing["cases"]],
        "max_abs_err": hw_max_abs,
        "ms": hw_timing["kernel_ms"], "device_ms": hw_timing["device_ms"],
        "plain_ms": hw_timing["plain_ms"],
        "bound_ms": hw_timing["bound_us"] / 1e3,
        "bound_by": hw_timing["bound_by"], "library_ms": None}, {
        # the time-major kernel it replaced, kept as its comparison
        # (hw_kernel_vs_plain: bit for bit on every lane of the four cases)
        "name": "hw_sse_time_major", "route": "cuda",
        "kernel": "hw_sse_kernel",
        "source": "spark_timeseries_tpu_torch/csrc/hw_sse.cu",
        "replaces": "docs/experiments/hw_pallas.py:61",
        "launches": paths.total["hw_sse_time_major"],
        "launches_by_path": paths.by_path["hw_sse_time_major"],
        "comparison_only": True,
        "by_case": [{"case": c["case"],
                     "kernel_ms": c["time_major_kernel_ms"],
                     "device_ms": c["time_major_device_ms"],
                     "call_ms": c["time_major_call_ms"],
                     "share_of_bound": c["time_major_share_of_bound"]}
                    for c in hw_timing["cases"]],
        "max_abs_err": hw_tm_max_abs,
        "ms": hw_timing["time_major_kernel_ms"],
        "plain_ms": hw_timing["plain_ms"],
        "bound_ms": hw_timing["bound_us"] / 1e3,
        "bound_by": hw_timing["bound_by"], "library_ms": None}, {
        "name": "hw_box_fit", "route": "cuda",
        "source": "spark_timeseries_tpu_torch/csrc/hw_sse.cu",
        "replaces": "docs/experiments/hw_pallas.py:61",
        "launches": hw_launches + hwr_row["hw_box_fit_launches"]
        + serv["hw_box_fit"] + flt["hw_box_fit"] + dur["hw_box_fit"]
        + obs["hw_box_fit"],
        "launches_by_path": {
            "hw_path": hw_launches,
            "hw_resilient_path": hwr_row["hw_box_fit_launches"],
            "serving_path": serv["hw_box_fit"],
            "fleet_path": flt["hw_box_fit"],
            "durable_path": dur["hw_box_fit"],
            "obs_path": obs["hw_box_fit"]},
        "max_abs_err": fit_row["vs_plain_max_abs_x_same_iter"],
        "ms": fit_row["box_fit_ms"], "plain_ms": fit_row["plain_ms"],
        "plain_lanes": fit_row["plain_lanes"],
        "bound_ms": fit_row["bound_ms"], "bound_by": fit_row["bound_by"],
        "library_ms": None}, {
        "name": "arma_lm_fit_grid", "route": "cuda",
        "source": "spark_timeseries_tpu_torch/csrc/arma_ne.cuh",
        "replaces": "spark_timeseries_tpu/ops/pallas_arma.py:229 "
                    "(y_blocks grid, :351)",
        "launches": grid_launches + panel_row["auto_fit_launches"]
        + res_grid + serv_row["arma_lm_fit_grid_launches"]
        + lng["arma_lm_fit_grid"],
        "launches_by_path": {
            "auto_fit_path": grid_launches,
            "panel_path": panel_row["auto_fit_launches"],
            "resilient_path": res_grid,
            "serving_path": serv_row["arma_lm_fit_grid_launches"],
            "long_path": lng["arma_lm_fit_grid"]},
        "max_abs_err": grid_row["vs_plain_max_abs_x_same_iter_converged"],
        "ms": grid_row["kernel_ms"], "plain_ms": grid_row["plain_ms"],
        "plain_lanes": grid_row["plain_lanes"],
        "bound_ms": grid_row["bound_ms"], "bound_by": grid_row["bound_by"],
        "padded_launch_ms": grid_row["padded_launch_ms"],
        "padded_bound_ms": grid_row["padded_bound_ms"],
        "library_ms": None}]})
    print_summary()
    print(smi, flush=True)
    check(not any(paths.total.values()),
          f"a path launched a time-major comparison kernel: "
          f"{paths.by_path}")
    check(cgd_row["vs_lm_share"] >= CGD_LM_FLOOR,
          f"css-cgd's neg-LL is within {CGD_LM_RTOL:g} of the css-lm fit's "
          f"on {cgd_row['vs_lm_share']:.4f} of {cgd_row['vs_lm_lanes']} "
          f"lanes (floor {CGD_LM_FLOOR}; worse on "
          f"{cgd_row['cgd_worse_share']:.4f}, better on "
          f"{cgd_row['cgd_better_share']:.4f})")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
