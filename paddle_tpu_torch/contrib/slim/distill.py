"""Knowledge distillation losses and the teacher/student program merge.

Counterpart of paddle_tpu/contrib/slim/distill.py (the reference's
slim/distillation/distiller.py: L2Distiller, FSPDistiller,
SoftLabelDistiller, and the distillation strategy's merge). The losses
are layer compositions appended to the current Program; ``merge`` copies
a teacher program into the student's under a name prefix, so one
Executor step runs both.
"""
from ... import layers
from ...framework.program import Parameter, default_main_program
from ...framework.scope import global_scope

__all__ = ["soft_label_loss", "l2_distill_loss", "fsp_matrix",
           "fsp_loss", "merge"]


def soft_label_loss(student_logits, teacher_logits,
                    student_temperature=1.0, teacher_temperature=1.0):
    """Cross-entropy between temperature-softened distributions
    (reference SoftLabelDistiller): mean(-sum(softmax(t / Tt) *
    log_softmax(s / Ts)))."""
    s = layers.scale(student_logits, scale=1.0 / student_temperature)
    t = layers.scale(teacher_logits, scale=1.0 / teacher_temperature)
    t_prob = layers.softmax(t)
    t_prob.stop_gradient = True
    s_log = layers.log_softmax(s)
    ce = layers.reduce_sum(layers.elementwise_mul(t_prob, s_log), dim=-1)
    return layers.scale(layers.reduce_mean(ce), scale=-1.0)


def l2_distill_loss(student_feature, teacher_feature):
    """L2 feature-map distillation (reference L2Distiller)."""
    teacher_feature.stop_gradient = True
    diff = layers.elementwise_sub(student_feature, teacher_feature)
    return layers.reduce_mean(layers.square(diff))


def fsp_matrix(feature_a, feature_b):
    """Flow-of-solution-procedure matrix (reference FSPDistiller
    _fsp_matrix): (N, C1, H, W) x (N, C2, H, W) -> (N, C1, C2), the mean
    over H * W of each position's channel outer product."""
    c1 = feature_a.shape[1]
    c2 = feature_b.shape[1]
    h, w = feature_a.shape[2], feature_a.shape[3]
    a = layers.reshape(feature_a, shape=[0, c1, h * w])
    b = layers.reshape(feature_b, shape=[0, c2, h * w])
    prod = layers.matmul(a, layers.transpose(b, perm=[0, 2, 1]))
    return layers.scale(prod, scale=1.0 / (h * w))


def fsp_loss(student_a, student_b, teacher_a, teacher_b):
    """FSP distillation loss between a student layer pair and a teacher
    layer pair (reference FSPDistiller)."""
    sm = fsp_matrix(student_a, student_b)
    tm = fsp_matrix(teacher_a, teacher_b)
    tm.stop_gradient = True
    return layers.reduce_mean(layers.square(
        layers.elementwise_sub(sm, tm)))


def merge(teacher_program, student_program=None, name_prefix="teacher_",
          scope=None):
    """Copy the teacher graph into the student program under a prefix
    (reference slim distillation_strategy's merge): the teacher's vars
    and parameters are renamed ``prefix + name``, marked stop_gradient
    (its parameters not trainable), and its feed vars keep their names,
    so one feed dict drives both nets. Each teacher persistable the
    scope holds is copied to its prefixed name as a tensor of its own (a
    clone): an in-place update of the student can never write the
    teacher's copy. That is every persistable, as the reference copies
    them, where the JAX package copies the Parameters only: a teacher's
    batch-norm statistics are persistables, and a ResNet teacher cannot
    run without them.

    Returns {original teacher var name: merged Variable}."""
    scope = scope if scope is not None else global_scope()
    student_program = student_program or default_main_program()
    if teacher_program.num_blocks > 1:
        raise NotImplementedError(
            "merge() supports single-block teacher programs; control-flow "
            "sub-blocks would need index remapping")
    t_block = teacher_program.global_block()
    s_block = student_program.global_block()

    def mapped(name):
        var = t_block.var(name)
        if getattr(var, "is_data", False):
            return name          # shared feeds
        return name_prefix + name

    var_map = {}
    for name, var in t_block.vars.items():
        new_name = mapped(name)
        if s_block.has_var(new_name):
            var_map[name] = s_block.var(new_name)
            continue
        kwargs = dict(name=new_name, shape=var.shape, dtype=var.dtype,
                      stop_gradient=True,
                      persistable=getattr(var, "persistable", False))
        if isinstance(var, Parameter):
            new = s_block.create_parameter(trainable=False, **kwargs)
        else:
            kwargs["is_data"] = getattr(var, "is_data", False)
            new = s_block.create_var(**kwargs)
        value = scope.find_var(name) if new.persistable else None
        if value is not None:
            scope.set_var(new_name, value.clone())
        var_map[name] = new

    for op in t_block.ops:
        s_block.append_op(
            op.type,
            inputs={slot: [mapped(n) for n in names]
                    for slot, names in op.inputs.items()},
            outputs={slot: [mapped(n) for n in names]
                     for slot, names in op.outputs.items()},
            attrs=dict(op.attrs))
    return var_map
