"""PyTorch/CUDA port of the IWAE framework, for NVIDIA Hopper (H100).

The JAX package ``iwae_replication_project_tpu`` beside this one is the
reference; this package mirrors its module names so each counterpart is easy
to find (``ops/hot_loop.py`` here ports ``ops/hot_loop.py`` there), and uses
the same parameter tree (``enc``/``dec``/``out`` blocks, weights ``[in, out]``)
so the reference's weights load through :mod:`.convert`.

What is ported so far:

* the serving ``score`` path (plus ``encode`` and ``decode``, which share
  the engine): ``zoo.serving_engine`` -> ``serving.engine.ServingEngine``
  -> ``serving.programs`` -> ``models.iwae.log_weights`` ->
  ``ops.hot_loop.decoder_score``, whose forward is the hand-written CUDA
  kernel in ``csrc/hot_loop_fwd.cu``;
* training: ``python -m iwae_replication_project_tpu_torch`` or
  ``zoo.train`` -> ``experiment.run_experiment`` (the Burda stages, in
  dispatches of ``PASS_BLOCK`` passes, with checkpoints and bitwise resume
  in ``utils.checkpoint``, preemption grace, and JSONL/TensorBoard logs in
  ``utils.logging``) -> ``training.epoch`` (on CUDA the step captured
  once as a CUDA graph and replayed) -> ``training.train_step`` ->
  ``objectives.gradients`` -> the same ``decoder_score``, whose
  ``FusedBlockLL`` autograd Function runs the backward kernel in
  ``csrc/hot_loop_bwd.cu``;
* evaluation, after each stage of ``run_experiment`` or on its own:
  ``evaluation.training_statistics`` (the seven scalars with the streamed
  k=5000 NLL, active units, the pruned NLL) and
  ``telemetry.diagnostics.estimator_diagnostics``, through the same
  forward kernel;
* the fused Bernoulli likelihood of the decoder's last layer,
  ``ops.fused_likelihood.fused_bernoulli_ll``, with its forward and
  backward kernels in ``csrc/fused_ll_fwd.cu`` and ``csrc/fused_ll_bwd.cu``;
* data and sample parallelism over ``torch.distributed``: ``parallel``
  (the ``(dp, sp)`` mesh, the sharded step, epoch and evaluation, the
  processes and their group, the DDP-placed step), which the driver takes
  under its mesh flags;
* the reference's facade, ``api.FlexibleModel``
  (``examples/experiment_example_torch.py``), with JAX's ``backend=``
  switch: ``"jax"`` the port's own path, ``"torch"`` and ``"tf2"`` the
  eager oracles of ``backends`` (``--backend`` in the driver);
* the lint framework, the concurrency rules and the race detector
  (``analysis``: ``python -m iwae_replication_project_tpu_torch.analysis``
  and ``.analysis.race``), with a fuzzed sweep of the serving tier;
* paper-grade k behind the serving API (``serving.sharded``, the large-k
  ``score`` and ``score_adaptive``) and the serving tier over TCP
  (``serving.frontend``: the JAX package's JSON-lines wire, router, server,
  client, remote replicas, quotas, retry and bulk jobs, with
  ``telemetry.tracing`` and ``telemetry.slo``), which the serving CLI runs
  in its tier and client modes;
* the driver's stage figures (``utils.viz``, PNG written with ``zlib``),
  its compile-cache directory and fields (``--compile-cache-dir``,
  ``ops._kernels.use_build_dir``), and the ``digits`` data carried in the
  package (``data/digits.csv.gz``).

The package imports ``torch`` and ``numpy`` only: never ``jax`` and nothing
of the JAX package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no explicit CPU request they raise.
"""
