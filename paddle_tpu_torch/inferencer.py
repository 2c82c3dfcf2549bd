"""High-level Inferencer API.

Counterpart of paddle_tpu/inferencer.py. ``infer`` routes through the
serving layer's shape-bucketing helper: varying client batch sizes pad
up to a small set of power-of-two buckets. Results are exact: pad rows
are stripped, and programs whose fetches aren't row-aligned fall back to
the direct (unpadded) run.

``place=None`` means ``CUDAPlace(0)``, which raises where CUDA is absent
(the reference's ``check_and_get_place`` falls back to the CPU; the port
never does).
"""
from . import framework
from . import executor
from . import io
from . import unique_name
from .core import places as _places

__all__ = ['Inferencer']


class Inferencer(object):
    def __init__(self, infer_func, param_path, place=None, parallel=False,
                 bucket_batches=True, bucket_policy=None,
                 optimize_for_inference=False):
        """``infer_func()`` builds the inference network and returns the
        variable to fetch; its parameters are read from ``param_path``
        (a ``save_params`` or ``save_inference_model`` directory).

        ``bucket_batches=False`` runs each batch size as it comes;
        ``bucket_policy`` overrides the default power-of-two
        :class:`~paddle_tpu_torch.serving.BucketPolicy`.

        ``optimize_for_inference=True`` runs the compiler's inference
        pipeline over the loaded program in place: BN folding into the
        conv/fc weights just loaded (<= 1e-5 drift) plus the default
        passes. Opt-in because the fold rewrites the scope's weights."""
        if parallel:
            raise NotImplementedError(
                'Inferencer(parallel=True): serving through the dp '
                'ParallelExecutor is not ported yet (ROADMAP Queue A '
                'item 1)')
        self.param_path = param_path
        self.scope = executor.Scope()
        self.place = place if place is not None else _places.CUDAPlace(0)
        self.exe = executor.Executor(self.place)
        if bucket_batches:
            from .serving.bucketing import BucketPolicy
            self.bucket_policy = bucket_policy or BucketPolicy()
        else:
            self.bucket_policy = None

        self.inference_program = framework.Program()
        # a private startup program: infer_func's parameter creation
        # must not leak init ops into the ambient global startup program;
        # the Inferencer never runs startup (params come from param_path)
        self.startup_program = framework.Program()
        with framework.program_guard(self.inference_program,
                                     self.startup_program):
            with unique_name.guard():
                self.predict_var = infer_func()

        io.load_params(self.exe, param_path,
                       main_program=self.inference_program,
                       scope=self.scope)

        if optimize_for_inference:
            from . import compiler as _compiler
            _compiler.optimize_inference(
                self.inference_program, scope=self.scope,
                fetch_names=[self.predict_var.name], clone=False)

    def infer(self, inputs, return_numpy=True):
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        if self.bucket_policy is not None:
            from .serving.bucketing import run_bucketed
            return run_bucketed(
                self.exe, self.inference_program, inputs,
                [self.predict_var], scope=self.scope,
                policy=self.bucket_policy, return_numpy=return_numpy)
        return self.exe.run(self.inference_program, feed=inputs,
                            fetch_list=[self.predict_var],
                            scope=self.scope, return_numpy=return_numpy)
