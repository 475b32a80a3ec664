"""Circuit compiler: signals/constraints stores, 3-mode evaluator, optimizer."""

from .signals import Signal, Signals  # noqa: F401
from .constraints import Constraints  # noqa: F401
from .evaluator import Evaluator, EvalError, Mode, Scope, ScopeValue  # noqa: F401
from .optimizer import optimize  # noqa: F401
