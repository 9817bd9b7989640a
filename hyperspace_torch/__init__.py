"""PyTorch/CUDA port of hyperspace_tpu.

The JAX package ``hyperspace_tpu`` is the reference; this package mirrors
its module names (``manifolds/``, ``kernels/``, ``data/``, ``nn/``,
``optim/``, ``models/``, ``train/``, ``telemetry/``, ``benchmarks/``,
``serve/``, ``cli/``) so a reader can find each counterpart.  It imports ``torch``, numpy and the
standard library only.  Kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc/``), built with ``nvcc`` at first use; every kernel has a
plain PyTorch version beside it that runs only for tensors on the CPU.

Ported so far: the exact and IVF/PQ serving paths (artifact →
``serve.QueryEngine`` → ``serve.RequestBatcher`` → ``serve.Collator`` →
``serve.HttpFrontDoor`` → ``cli.serve``, with deadlines, admission, the
degradation ladder, access logs and the telemetry registry; the live
index, the multi-tenant engine registry and blue-green rollover), and
the five training workloads of ``cli.train`` (HGCN, HyboNet, Poincaré
and product-manifold embeddings, the hyperbolic VAE) through one
training loop (``train.loop.run_loop``: checkpoint and resume, JSONL
records, health samples, gradient accumulation, the telemetry spine and
the divergence guard), every one of them in graphed chunks on the card
(``scan_chunk``).  ``ROADMAP.md`` lists what is left.
"""

__version__ = "0.1.0"
