"""The examples of the port, each the counterpart of the JAX package's
script of the same name under `examples/`:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.streaming_updates [--churn|--serve|...]
    python -m repro_torch.examples.rag_serve [--device cpu]
    python -m repro_torch.examples.train_lm [--full] [--device cpu]

Each runs on the card unless it is given `--device cpu` (or
`device="cpu"` on its functions), and raises without a card otherwise.
Their functions return what they print, as data.
"""
