"""The benchmark's plain reference: plain PyTorch that imports nothing of
the port, nor JAX, nor the JAX package.  ``port/`` is a frozen copy of
the port's plain code; ``train.py`` recomputes the training cells' first
updates from the seed, ``rollout.py`` the fused rollouts' answers for a
sample of instances."""
