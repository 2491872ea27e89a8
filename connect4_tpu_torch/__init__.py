"""connect4_tpu_torch — the PyTorch/CUDA port of ``connect4_tpu``.

A package of its own beside the JAX package, which stays the reference:
the same environment, network, batched MCTS, self-play, learner, training
loop and matches, in PyTorch for one NVIDIA H100, with the JAX package's Pallas kernel rewritten by hand in
CUDA (``models/csrc``). It imports neither JAX nor ``connect4_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
