"""Legacy memory_optimize API.

Reference: python/paddle/fluid/transpiler/memory_optimization_transpiler
(var reuse analysis); the JAX package's fluid/transpiler/
memory_optimize.py.  Both calls are documented no-ops, as the
reference's own deprecation of the API in favour of build-strategy
passes has them: the executor already releases each intermediate after
its last reader and writes the persistable variables in place, and a
program replayed from a CUDA graph takes its intermediates from the
graph's memory pool.
"""


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    return None


def release_memory(input_program, skip_opt_set=None):
    return None
