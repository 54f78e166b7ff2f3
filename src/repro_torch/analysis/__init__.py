"""Static analysis of the port (``python -m repro_torch check``).

Two layers over one report schema (the JAX package's):

- **graph_checks** — the trace-time invariant analyzer: traces the real
  step constructors for every registry config over fake tensors
  (``FakeTensorMode`` + ``make_fx``) and proves the serve/train structural
  invariants (one host-transfer surface per decode step, integer-operand
  products with no float dequant materialised, the prefill recompile
  surface, plan coverage, kernel routing) without a card, an allocation or
  a launch.  Each CUDA kernel is a ``torch.library`` operator, so it is one
  node of the graph: the counterpart of ``pallas_call`` in a jaxpr.
- **lint** — the repo's AST rules QFT001..QFT006 with
  ``# qft: noqa[RULE]`` suppression.

``runner.run_check`` composes both into a :class:`report.Report`.
"""
from .lint import RULES, lint_paths, lint_source           # noqa: F401
from .report import SCHEMA_VERSION, Diagnostic, Report     # noqa: F401
from .runner import run_check                              # noqa: F401
