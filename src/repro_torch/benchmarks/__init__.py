"""The paper's experiments on the port: the subject model and evaluation
protocol (``common``), one module per table or figure, and the harness
that runs them (``python -m repro_torch.benchmarks.run``)."""
