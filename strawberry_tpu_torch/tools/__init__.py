"""Measurements that set the port's routing defaults (routing.py), the
counterparts of the JAX package's routing tools:

    python -m strawberry_tpu_torch.tools.em_crossover      [--device cpu]
    python -m strawberry_tpu_torch.tools.mcf_crossover     [--device cpu]
    python -m strawberry_tpu_torch.tools.prep_crossover    [--device cpu]
    python -m strawberry_tpu_torch.tools.device_character  [--device cpu]

Each runs on the GPU unless given --device cpu (the plain PyTorch
versions, for the tests: no time it prints there is a time of the card),
prints one JSON line that starts with the card's name and power limit,
and with --out also writes it to
build/strawberry_tpu_torch/crossover/<tool>.json.
"""
