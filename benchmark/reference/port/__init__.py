"""A frozen copy of the port's plain PyTorch code for the layers that the
training cells time: the engines (``checkers.py``, ``roadway.py`` with
``roadway_soa.py``; ``checkers_packed.py`` and ``philox.py`` for the
fused rollouts), the hooks (``experiments.py``), the replay
(``buffer.py``), the nets (``nets.py``) and the algorithm
(``common.py``, ``base.py``, ``cm3.py``), with the configuration's
dataclasses (``config.py``), the tree helpers (``tree.py``) and the key
derivation (``prng.py``).

Each file is the port's module of the same name as it stood when the
benchmark was written, with its imports made relative, cut to what the
benchmark's configurations run (Checkers and roadway, CM3 at stage 2
with Q_credit, the optax path, one seed in flattened modules, the plain
and dual replay, the generator draws), and one edit:
``nets.full_float32`` can be switched to TF32 for the comparison's
control.  The parts left out (the other experiments' and algorithms'
nets and hooks, the seed stacks, the sharded replay, the fed and block
draws, the mesh, the fused optimizer, the V critic, stage 1, the
occlusion, the evaluation's metrics) are refused where a configuration
asks for them.  Nothing here imports the port: a later
change to the port leaves this copy as it is, so the comparison holds
the port to what it computed when the benchmark was defined."""
