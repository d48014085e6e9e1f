"""PyTorch and CUDA port of ``attentionalpoolingaction_tpu``.

The package mirrors the JAX package's module names.  Public functions keep
the JAX layouts (NHWC images; pooling ops on ``x (B, N, F)``) so that the
two can be held against each other on the same inputs.  It imports torch,
numpy and the standard library, never JAX or the JAX package.

Entry points (``serving.Predictor``, ``train.build_model``,
``models.get_model``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise.
"""
