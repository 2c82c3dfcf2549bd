"""Optimizers.

Counterpart of paddle_tpu/optimizer.py: SGD, Momentum, Adagrad, Adam,
Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl and ModelAverage. The
same program surgery: ``minimize`` appends the backward marker,
gradient-clip ops, regularizer ops, one update op per parameter, and the
finish-update ops (Adam's and Adamax's beta-power scaling), all in the
loss's block. Accumulators are persistable variables initialised by the
startup program, under paddle_tpu's names, so they live in the Scope on
the device beside the parameters. ``ModelAverage`` keeps its running
sums as tensors on the device of the Scope's parameters.
"""
import contextlib

from . import framework, unique_name
from .framework import Variable, default_startup_program
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .regularizer import append_regularization_ops
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ['SGD', 'Momentum', 'Adagrad', 'Adam', 'Adamax', 'DecayedAdagrad',
           'Ftrl', 'SGDOptimizer', 'MomentumOptimizer', 'AdagradOptimizer',
           'AdamOptimizer', 'AdamaxOptimizer', 'DecayedAdagradOptimizer',
           'RMSPropOptimizer', 'FtrlOptimizer', 'Adadelta', 'RMSProp',
           'AdadeltaOptimizer', 'ModelAverage', 'Optimizer']


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate should be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = {}
        self._main_program = None      # bound by minimize() to loss program
        self._startup_program = None
        self.helper = None

    # ---- learning rate ----------------------------------------------------------
    def _target_programs(self):
        main = self._main_program or framework.default_main_program()
        startup = self._startup_program or default_startup_program()
        return main, startup

    def _create_global_learning_rate(self):
        program, startup_program = self._target_programs()
        if self._learning_rate_map.get(program) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        self._learning_rate_map[program] = self._persistable_scalar(
            'learning_rate', float(self._learning_rate))

    def _persistable_scalar(self, key, value):
        """A persistable float32 [1] named from ``key``, set to
        ``value`` by the startup program (the LR, the beta powers)."""
        program, startup_program = self._target_programs()
        name = unique_name.generate(key)
        var = program.global_block().create_var(
            name=name, shape=(1,), dtype='float32', persistable=True)
        startup = startup_program.global_block()
        sv = startup.create_var(name=name, shape=(1,), dtype='float32',
                                persistable=True)
        Constant(value)(sv, startup)
        return var

    def _global_learning_rate(self, program=None):
        if program is None:
            program = self._target_programs()[0]
        return self._learning_rate_map.get(program, None)

    def _create_param_lr(self, param_and_grad):
        """The global learning rate, scaled by the parameter's own
        ``optimize_attr['learning_rate']`` when that is not 1."""
        param_lr = param_and_grad[0].optimize_attr.get('learning_rate', 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        block = self._target_programs()[0].global_block()
        out = block.create_var(
            name=unique_name.generate('lr_scaled'), shape=(1,),
            dtype='float32')
        block.append_op(type='scale', inputs={'X': base},
                        outputs={'Out': out}, attrs={'scale': param_lr})
        return out

    # ---- accumulators -----------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators.get(name, {}):
            raise Exception("Accumulator {} already exists for parameter {}"
                            .format(name, param.name))
        shape = list(shape or param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate(param.name + "_" + name)
        program, startup_program = self._target_programs()
        var = program.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True)
        startup = startup_program.global_block()
        sv = startup.create_var(name=var_name, shape=shape, dtype=dtype,
                                persistable=True)
        Constant(float(fill_value))(sv, startup)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        try:
            return self._accumulators[name][param.name]
        except KeyError:
            raise Exception("Accumulator {} does not exist for parameter {}"
                            .format(name, param.name)) from None

    # ---- hooks ------------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError()

    # ---- minimize ---------------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        self._main_program = program
        if startup_program is not None:
            self._startup_program = startup_program
        block = program.global_block()
        # named like the JAX package's helper, so both packages draw the
        # same unique names
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_accumulators(block,
                                  [p[0] for p in parameters_and_grads])
        self._create_global_learning_rate()
        optimize_ops = [self._append_optimize_op(block, pg)
                        for pg in parameters_and_grads
                        if pg[1] is not None and pg[0].trainable]
        self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, zero_stage=None, bucket_bytes=None):
        """Append backward, clip, regularizer and update ops for ``loss``;
        returns (optimize_ops, params_grads). ``zero_stage`` opts the
        program into ZeRO at build time, as in the JAX package: stage >= 1
        shards the accumulators created here over the current mesh's dp
        group (``parallel.mesh``), stage >= 2 also plants the bucketed
        reduce-scatter of the gradient tail (``bucket_bytes`` a bucket).
        A ParallelExecutor applies the same by default over more than one
        rank; on a group of one it changes nothing."""
        self._main_program = loss.block.program
        self._startup_program = startup_program
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(
            params_grads, loss, startup_program)
        if zero_stage is not None and int(zero_stage) > 0:
            from .compiler import zero as _zero
            from .parallel.mesh import _current_mesh
            from .partition import mesh_axis_extent
            _zero.apply_zero(self._main_program,
                             mesh_axis_extent(_current_mesh, 'dp'),
                             stage=zero_stage, bucket_bytes=bucket_bytes)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0]})


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str,
                                             param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Velocity": velocity_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "VelocityOut": velocity_acc},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1.0e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": moment_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "MomentOut": moment_acc},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow_acc = None
        self._beta2_pow_acc = None

    def _create_accumulators(self, block, parameters):
        self._beta1_pow_acc = self._persistable_scalar('beta1_pow_acc',
                                                       self._beta1)
        self._beta2_pow_acc = self._persistable_scalar('beta2_pow_acc',
                                                       self._beta2)
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment1 = self._get_accumulator(self._moment1_acc_str,
                                        param_and_grad[0])
        moment2 = self._get_accumulator(self._moment2_acc_str,
                                        param_and_grad[0])
        return block.append_op(
            type="adam",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment1": moment1, "Moment2": moment2,
                    "Beta1Pow": self._beta1_pow_acc,
                    "Beta2Pow": self._beta2_pow_acc},
            outputs={"ParamOut": param_and_grad[0], "Moment1Out": moment1,
                     "Moment2Out": moment2},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block):
        block.append_op(type="scale", inputs={"X": self._beta1_pow_acc},
                        outputs={"Out": self._beta1_pow_acc},
                        attrs={"scale": self._beta1})
        block.append_op(type="scale", inputs={"X": self._beta2_pow_acc},
                        outputs={"Out": self._beta2_pow_acc},
                        attrs={"scale": self._beta2})


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamaxOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow_acc = None

    def _create_accumulators(self, block, parameters):
        self._beta1_pow_acc = self._persistable_scalar('adamax_beta1_pow',
                                                       self._beta1)
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type="adamax",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment": moment, "InfNorm": inf_norm,
                    "Beta1Pow": self._beta1_pow_acc},
            outputs={"ParamOut": param_and_grad[0], "MomentOut": moment,
                     "InfNormOut": inf_norm},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block):
        block.append_op(type="scale", inputs={"X": self._beta1_pow_acc},
                        outputs={"Out": self._beta1_pow_acc},
                        attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1.0e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate,
                                                      **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": moment_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "MomentOut": moment_acc},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """Adadelta takes no learning rate in its update, as in the
    reference: ``learning_rate`` only makes the optimizer's LR variable."""
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1.0e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        avg_squared_grad_acc = self._get_accumulator(
            self._avg_squared_grad_acc_str, param_and_grad[0])
        avg_squared_update_acc = self._get_accumulator(
            self._avg_squared_update_acc_str, param_and_grad[0])
        return block.append_op(
            type="adadelta",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "AvgSquaredGrad": avg_squared_grad_acc,
                    "AvgSquaredUpdate": avg_squared_update_acc},
            outputs={"ParamOut": param_and_grad[0],
                     "AvgSquaredGradOut": avg_squared_grad_acc,
                     "AvgSquaredUpdateOut": avg_squared_update_acc},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1.0e-6,
                 momentum=0.0, **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._momentum_acc_str,
                                             param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str,
                                                param_and_grad[0])
        return block.append_op(
            type="rmsprop",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": momentum_acc, "MeanSquare": mean_square_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "MomentOut": momentum_acc,
                     "MeanSquareOut": mean_square_acc},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        squared_acc = self._get_accumulator(self._squared_acc_str,
                                            param_and_grad[0])
        linear_acc = self._get_accumulator(self._linear_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type="ftrl",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "SquaredAccumulator": squared_acc,
                    "LinearAccumulator": linear_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "SquaredAccumOut": squared_acc,
                     "LinearAccumOut": linear_acc},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class ModelAverage(Optimizer):
    """A running average of the parameters, swapped in for evaluation.

    Counterpart of paddle_tpu's ModelAverage: ``update(scope)`` (after a
    training step) adds each parameter of the default main program to
    its running sum, and a window past ``max_average_window`` starts
    over; ``apply()`` is a context manager that puts sum / count into
    the scope and, with ``need_restore``, puts the trained tensors back
    on exit (``restore()`` does it by hand). The sums are tensors on the
    device of the Scope's parameters; the trained tensors are kept as
    they are, so a restore gives back the same bits.
    """

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super(ModelAverage, self).__init__(0.0001, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._sums = {}
        self._num = 0
        self._backup = {}
        self.params_grads = []

    def update(self, scope=None):
        from .executor import global_scope
        scope = scope or global_scope()
        program = framework.default_main_program()
        for p in program.global_block().all_parameters():
            val = scope.raw(p.name)
            if val is None:
                continue
            total = self._sums.get(p.name)
            self._sums[p.name] = val.clone() if total is None else \
                total + val
        self._num += 1
        if self._num > self.max_average_window:
            self._sums = {}
            self._num = 0

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def _ctx():
            from .executor import global_scope
            scope = global_scope()
            self._backup = {}
            for name, total in self._sums.items():
                cur = scope.raw(name)
                if cur is None or self._num == 0:
                    continue
                self._backup[name] = cur
                scope.set_var(name, total / float(self._num))
            yield
            if need_restore:
                self.restore()
        return _ctx()

    def restore(self, executor=None):
        from .executor import global_scope
        scope = global_scope()
        for name, val in self._backup.items():
            scope.set_var(name, val)
        self._backup = {}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
