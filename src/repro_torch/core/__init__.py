"""QFT core (PyTorch): fake-quant, MMSE scales, the offline subgraph,
QuantPlan resolution and device-side sampling."""
