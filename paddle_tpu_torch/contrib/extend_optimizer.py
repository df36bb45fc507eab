"""Extended optimizers: gradient merge and pipeline (counterpart of
paddle_tpu/contrib/extend_optimizer.py; fluid's GradientMergeOptimizer and
PipelineOptimizer).

``GradientMergeOptimizer(inner, k_steps, avg)`` adds each step's gradient
into a persistable ``<param>.grad_acc_<n>`` buffer and hands the inner
optimizer the (averaged) sum every ``k_steps``-th run of the step, chosen
by a ``where`` on the ``@GRAD_MERGE_STEP@`` counter: no host branch, so
the step stays one captured CUDA graph on the card. As in the JAX package,
a run that does not apply still runs the inner optimizer, on a zero
gradient: an Adam inner then moves its moments, and its parameters by
Adam's step of those moments.

``PipelineOptimizer`` annotates each parameter's ``pipeline_stage`` in
contiguous groups and runs the inner ``minimize``, as the JAX package's
does; the pipelined schedule itself belongs to the multi-GPU slice
(``framework/compiler.py`` raises ``NotPortedError`` for it).
"""
from ..framework import unique_name
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from .. import layers
from ..layers import tensor as _tensor


class GradientMergeOptimizer(object):
    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        inner = self.inner_optimizer
        params_grads = inner.backward(loss, startup_program,
                                      parameter_list, no_grad_set)
        if self.k_steps == 1:
            inner.apply_gradients(params_grads)
            return [], params_grads

        helper = LayerHelper("gradient_merge")
        step = layers.autoincreased_step_counter(
            counter_name="@GRAD_MERGE_STEP@", begin=1)
        stepf = layers.cast(step, "float32")
        k = layers.fill_constant([1], "float32", float(self.k_steps))
        rem = layers.elementwise_sub(
            stepf,
            layers.elementwise_mul(
                layers.floor(layers.elementwise_div(stepf, k)), k))
        is_apply = layers.equal(rem, 0.0)

        merged = []
        for p, g in params_grads:
            acc = helper.create_global_variable(
                name=unique_name.generate(p.name + ".grad_acc"),
                dtype="float32", shape=p.shape, persistable=True)
            helper.set_variable_initializer(acc, ConstantInitializer(0.0))
            acc_new = layers.elementwise_add(acc, g)
            scale = 1.0 / self.k_steps if self.avg else 1.0
            apply_grad = layers.scale(acc_new, scale=scale)
            # the buffer restarts on an apply step, accumulates otherwise
            _tensor.assign(layers.where(is_apply,
                                        layers.zeros_like(acc_new),
                                        acc_new), acc)
            merged.append((p, apply_grad))

        # the inner update on every run: a zero gradient off apply steps
        inner.apply_gradients([
            (p, layers.where(is_apply, g, layers.zeros_like(g)))
            for p, g in merged])
        return [], merged


class PipelineOptimizer(object):
    def __init__(self, inner_optimizer, num_stages=2, num_microbatches=1,
                 stage_axis="pp"):
        self.inner_optimizer = inner_optimizer
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.stage_axis = stage_axis

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params = loss.block.program.all_parameters()
        per_stage = max(1, len(params) // self.num_stages)
        for i, p in enumerate(params):
            p.pipeline_stage = min(i // per_stage, self.num_stages - 1)
        return self.inner_optimizer.minimize(loss, startup_program,
                                             parameter_list, no_grad_set)
