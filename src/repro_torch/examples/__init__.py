"""The port's examples: the reference's ``examples/`` as entry points of
the package, each run as ``python -m repro_torch.examples.<name>``.

  ``quickstart``       design, theory checks, the ``rbgp4mm`` kernel, one
                       layer through every registered backend, training
                       through a fixed mask, the plan API.
  ``train_sparse_lm``  a TinyLlama-family LM under a SparsityPlan, with
                       plan-fingerprinted checkpoints, auto-resume and the
                       failure drill.
  ``serve_lm``         prefill + decode of a gemma3-family LM (both KV
                       cache kinds), greedy and temperature sampling.
  ``cifar_vgg_rbgp4``  the paper's protocol: a dense teacher, then
                       unstructured and RBGP4 students trained with KD.

Each runs on the card by default (``--device cpu`` for the CPU); its steps
are functions that take the sizes the reference hard-codes, with the
reference's values as defaults.  Nothing runs at import.
"""
