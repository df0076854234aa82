"""PyTorch/CUDA port of the IWAE framework, for NVIDIA Hopper (H100).

The JAX package ``iwae_replication_project_tpu`` beside this one is the
reference; this package mirrors its module names so each counterpart is easy
to find (``ops/hot_loop.py`` here ports ``ops/hot_loop.py`` there), and uses
the same parameter tree (``enc``/``dec``/``out`` blocks, weights ``[in, out]``)
so the reference's weights load through :mod:`.convert`.

What is ported so far is the serving ``score`` path (plus ``encode`` and
``decode``, which share the engine): ``zoo.serving_engine`` ->
``serving.engine.ServingEngine`` -> ``serving.programs`` ->
``models.iwae.log_weights`` -> ``ops.hot_loop.decoder_score``, whose forward
is the hand-written CUDA kernel in ``csrc/hot_loop_fwd.cu``.

The package imports ``torch`` and ``numpy`` only: never ``jax`` and nothing
of the JAX package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no explicit CPU request they raise.
"""
