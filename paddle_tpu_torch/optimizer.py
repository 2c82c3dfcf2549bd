"""Optimizers.

Counterpart of paddle_tpu/optimizer.py, trimmed to SGD, Momentum and
Adam. The same program surgery: ``minimize`` appends the backward marker,
gradient-clip ops, regularizer ops, one update op per parameter, and the
finish-update ops (Adam's beta-power scaling), all in the loss's block.
Accumulators are persistable variables initialised by the startup
program, so they live in the Scope on the device beside the parameters.
"""
from . import framework, unique_name
from .framework import Variable, default_startup_program
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .regularizer import append_regularization_ops
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ['SGD', 'Momentum', 'Adam', 'SGDOptimizer', 'MomentumOptimizer',
           'AdamOptimizer', 'Optimizer']


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
        name = unique_name.generate('learning_rate')
        lr_var = program.global_block().create_var(
            name=name, shape=(1,), dtype='float32', persistable=True)
        startup = startup_program.global_block()
        sv = startup.create_var(name=name, shape=(1,), dtype='float32',
                                persistable=True)
        Constant(float(self._learning_rate))(sv, startup)
        self._learning_rate_map[program] = lr_var

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
        returns (optimize_ops, params_grads). ``zero_stage`` (ZeRO
        sharding of the optimizer state over data-parallel ranks) belongs
        to the parallel slice: a stage above 0 raises. Stage 0 (or None)
        is plain training, and ``bucket_bytes`` only matters with ZeRO."""
        if zero_stage is not None and int(zero_stage) > 0:
            raise NotImplementedError(
                "minimize(zero_stage=%r): ZeRO is not ported yet (ROADMAP "
                "Queue A, the parallel slice)" % (zero_stage,))
        self._main_program = loss.block.program
        self._startup_program = startup_program
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(
            params_grads, loss, startup_program)
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
        program, startup_program = self._target_programs()
        startup = startup_program.global_block()
        for name, val in [('beta1_pow_acc', self._beta1),
                          ('beta2_pow_acc', self._beta2)]:
            var_name = unique_name.generate(name)
            var = program.global_block().create_var(
                name=var_name, shape=(1,), dtype='float32', persistable=True)
            sv = startup.create_var(name=var_name, shape=(1,),
                                    dtype='float32', persistable=True)
            Constant(val)(sv, startup)
            setattr(self, '_' + name, var)
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


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
