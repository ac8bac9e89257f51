from smatcher.utils.profiling import PhaseTimer, time_jit, trace, emit_jsonl
from smatcher.utils.debug import dprint
from smatcher.utils.cache import enable_compile_cache

__all__ = ["PhaseTimer", "time_jit", "trace", "emit_jsonl", "dprint"]
