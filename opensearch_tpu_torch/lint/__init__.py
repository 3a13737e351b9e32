"""tpulint's analysis core for the port: file context, suppressions, the
checker protocol and runner (``core``), thread-role inference
(``threadroles``) and the whole-program role pass (``callgraph``), each a
copy of the reference linter's module pointed at ``opensearch_tpu_torch/``.

The rule registry (``rules``: ``ALL_CHECKERS``, ``RULES``), the CLI
(``python -m opensearch_tpu_torch.lint``), the CFG, ``--explain``,
``--fix`` and the baseline come with the linter's last slice. Until then
:func:`lint_paths` runs the checkers it is handed, and raises
``NotImplementedError`` when asked for the registry's. Suppress a line
with ``# tpulint: disable=TPU00N``.
"""

from opensearch_tpu_torch.lint.core import (  # noqa: F401
    Checker,
    FileContext,
    Violation,
    lint_paths,
    lint_source,
)
