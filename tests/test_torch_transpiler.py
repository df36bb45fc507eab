"""The transpiler package, the parameter-server stubs and the small
top-level helpers of the port, each held to the JAX package's module on
the same inputs: the transpiler's trainer program, memory_optimize, the
dispatchers, union-find, program_utils edits, lookup-table finding, the
distributed-variable registry, the port-liveness wait, the stubs' guided
errors, the rank helpers, the logger, the net drawer, the decorators,
sysconfig and the demo data generators.
"""
import logging
import os
import socket

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt


def _program(pkg, distributed=True):
    """A lookup table read twice (distributed), an fc and a mean:
    (main, startup)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.layers.data("ids", [4, 1], dtype="int64",
                              append_batch_size=False)
        emb = pkg.layers.embedding(ids, size=[100, 8],
                                   is_distributed=distributed,
                                   param_attr=pkg.ParamAttr(name="tbl"))
        pkg.layers.embedding(ids, size=[100, 8], is_distributed=distributed,
                             param_attr=pkg.ParamAttr(name="tbl"))
        pkg.layers.mean(pkg.layers.fc(emb, 3))
    return main, startup


def _op_types(prog):
    return [op.type for op in prog.global_block().ops]


@pytest.fixture
def no_mesh():
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu_torch.distributed import mesh as tmesh
    jmesh.reset_mesh()
    tmesh.reset_mesh()
    yield jmesh, tmesh
    jmesh.reset_mesh()
    tmesh.reset_mesh()


@pytest.mark.parametrize("trainers", [1, 16])
def test_the_transpiler_returns_the_same_program(no_mesh, trainers):
    """With one trainer, or more trainers than this process sees
    devices, both packages install no mesh and hand back the Program they
    were given, its distributed table's sharding as the layer set it."""
    jmesh, tmesh = no_mesh
    out = []
    for pkg in (pt, ptt):
        main, startup = _program(pkg)
        t = pkg.DistributeTranspiler()
        with pytest.raises(RuntimeError, match="transpile"):
            t.get_trainer_program()
        t.transpile(0, program=main, trainers=trainers,
                    pservers="10.0.0.1:6174, 10.0.0.2:6174",
                    startup_program=startup)
        assert t.get_trainer_program() is main
        assert t.get_startup_program() is startup
        assert t.trainer_num == trainers and t.trainer_id == 0
        with pytest.raises(NotImplementedError, match="pserver"):
            t.get_pserver_program("10.0.0.1:6174")
        with pytest.raises(NotImplementedError):
            t.get_pserver_programs("10.0.0.1:6174")
        with pytest.raises(NotImplementedError):
            pkg.DistributeTranspiler().transpile(0, program=main,
                                                 sync_mode=False)
        tbl = main.global_block().var("tbl")
        out.append((_op_types(main), t.pserver_endpoints, tbl.sharding))
    assert out[0] == out[1]
    assert out[1][1] == ["10.0.0.1:6174", "10.0.0.2:6174"]
    assert jmesh.get_mesh() is None and tmesh.get_mesh() is None


def test_the_transpiler_config_is_checked():
    cfg = ptt.DistributeTranspilerConfig()
    assert (cfg.slice_var_up, cfg.min_block_size, cfg.mode) == (
        pt.DistributeTranspilerConfig.slice_var_up,
        pt.DistributeTranspilerConfig.min_block_size,
        pt.DistributeTranspilerConfig.mode)
    cfg.split_method = None
    assert ptt.DistributeTranspiler(cfg).config.split_method is \
        ptt.transpiler.RoundRobin
    cfg.min_block_size = 1024
    with pytest.raises(ValueError, match="min_block_size"):
        ptt.DistributeTranspiler(cfg)


def test_memory_optimize_stamps_the_request_and_changes_nothing():
    for pkg in (pt, ptt):
        main, _ = _program(pkg)
        before = main.to_json() if hasattr(main, "to_json") else None
        ops, version = _op_types(main), main._version
        assert pkg.memory_optimize(main, skip_opt_set={"x"}) is main
        assert pkg.release_memory(main) is main
        assert _op_types(main) == ops and main._version == version
        if before is not None:
            assert main.to_json() == before
        assert main._memory_optimize_requested and \
            main._release_memory_requested
        assert main._memory_optimize_skip == {"x"}
        with pytest.raises(ValueError):
            pkg.memory_optimize(main, level=2)
        with pytest.raises(TypeError):
            pkg.memory_optimize("not a program")
        with pytest.raises(TypeError):
            pkg.release_memory(None)


class _Var(object):
    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name


def test_the_dispatchers_give_the_jax_packages_endpoints():
    from paddle_tpu.transpiler import ps_dispatcher as jps
    from paddle_tpu_torch.transpiler import ps_dispatcher as tps
    eps = ["a:1", "b:2", "c:3"]
    names = ["w%d" % i for i in range(7)] + ["fc_0.b_0", "emb"]
    for cls in ("RoundRobin", "HashName"):
        j, t = getattr(jps, cls)(eps), getattr(tps, cls)(eps)
        got = [t.dispatch([_Var(n) for n in names]) for _ in range(2)]
        want = [j.dispatch([_Var(n) for n in names]) for _ in range(2)]
        assert got == want and t.eps == eps
        t.reset()
        j.reset()
        assert t.dispatch([_Var("w0")]) == j.dispatch([_Var("w0")])
    with pytest.raises(NotImplementedError):
        tps.PSDispatcher(eps).dispatch([])


def test_union_find_gives_the_jax_packages_groups():
    from paddle_tpu.transpiler.details.ufind import UnionFind as J
    from paddle_tpu_torch.transpiler.details.ufind import UnionFind as T
    rng = np.random.RandomState(3)
    pairs = rng.randint(0, 20, (15, 2)).tolist()
    j, t = J(range(10)), T(range(10))
    for a, b in pairs:
        j.union(a, b)
        t.union(a, b)
    for a in range(22):
        for b in range(22):
            assert t.is_connected(a, b) == j.is_connected(a, b)
        assert t.find(a) == j.find(a)


def test_program_utils_edit_as_the_jax_package():
    from paddle_tpu.transpiler.details import program_utils as jpu
    from paddle_tpu_torch.transpiler import details as tpu
    got = []
    for pkg, pu in ((pt, jpu), (ptt, tpu)):
        main, _ = _program(pkg)
        blk = main.global_block()
        found = (pu.find_op_by_input_arg(blk, "ids"),
                 pu.find_op_by_input_arg(blk, "tbl"),
                 pu.find_op_by_input_arg(blk, "nothing"),
                 pu.find_op_by_output_arg(blk, "embedding_0.tmp_0"),
                 pu.find_op_by_output_arg(blk, "embedding_1.tmp_0",
                                          reverse=True))
        version = main._version
        pu.delete_ops(blk, [blk.ops[1], blk.ops[3]])
        got.append((found, _op_types(main), main._version - version))
    assert got[0] == got[1]
    assert got[1][0] == (0, 0, -1, 0, 1) and got[1][2] == 1


def test_the_distributed_lookup_table_is_found_as_the_jax_package():
    from paddle_tpu import distribute_lookup_table as jd
    from paddle_tpu_torch import distribute_lookup_table as td
    jm, _ = _program(pt)
    tm, _ = _program(ptt)
    assert td.find_distributed_lookup_table(tm) == \
        jd.find_distributed_lookup_table(jm) == "tbl"
    assert td.find_distributed_lookup_table_inputs(tm, "tbl") == \
        jd.find_distributed_lookup_table_inputs(jm, "tbl") == ["ids", "ids"]
    assert td.find_distributed_lookup_table_outputs(tm, "tbl") == \
        jd.find_distributed_lookup_table_outputs(jm, "tbl")
    local, _ = _program(ptt, distributed=False)
    assert td.find_distributed_lookup_table(local) is None


def test_the_distributed_var_registry_matches_the_jax_packages():
    from paddle_tpu.transpiler.details import vars_distributed as jv
    from paddle_tpu_torch.transpiler.details import vars_distributed as tv
    out = []
    for v in (jv, tv):
        a = v.VarStruct("w", (8, 4), "float32", persistable=True)
        s = v.VarStruct("w.block0", (4, 4), "float32", persistable=True)
        reg = v.VarsDistributed()
        reg.add_distributed_var(a, s, is_slice=True, block_id=0, offset=0,
                                endpoint="a:1")
        d = reg.get_distributed_var_by_slice("w.block0")
        out.append((repr(a), repr(d), d.is_slice, d.offset,
                    reg.get_distributed_var_by_origin_and_ep("w", "a:1")
                    is d,
                    reg.get_distributed_var_by_origin_and_ep("w", "b:2"),
                    v.VarDistributed.equal(a, a),
                    v.VarDistributed.equal(a, s)))
    assert out[0] == out[1]


def test_wait_server_ready_waits_for_a_listening_port():
    from paddle_tpu_torch.transpiler.details.checkport import \
        wait_server_ready
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        wait_server_ready(["127.0.0.1:%d" % port], timeout_s=5.0,
                          poll_s=0.1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    with pytest.raises(TimeoutError, match=str(closed)):
        wait_server_ready(["127.0.0.1:%d" % closed], timeout_s=0.3,
                          poll_s=0.1)


def test_the_parameter_server_stubs_raise_as_the_jax_packages():
    import paddle_tpu.communicator as jc
    import paddle_tpu.distributed.downpour as jdp
    import paddle_tpu.distributed.node as jn
    import paddle_tpu.distributed.ps_pb2 as jpb
    import paddle_tpu.transpiler.geo_sgd_transpiler as jg
    from paddle_tpu.incubate.fleet.parameter_server import pslib as jpsl
    from paddle_tpu_torch import communicator as tc
    from paddle_tpu_torch.distributed import downpour as tdp
    from paddle_tpu_torch.distributed import node as tn
    from paddle_tpu_torch.distributed import ps_pb2 as tpb
    from paddle_tpu_torch.transpiler import geo_sgd_transpiler as tg
    from paddle_tpu_torch.incubate.fleet.parameter_server import pslib as tps
    cases = [(jc, tc, lambda m: m.Communicator()),
             (jdp, tdp, lambda m: m.DownpourSGD(0.1)),
             (jn, tn, lambda m: m.DownpourServer()),
             (jn, tn, lambda m: m.DownpourWorker()),
             (jg, tg, lambda m: m.GeoSgdTranspiler()),
             (jpb, tpb, lambda m: m.PSParameter),
             (jpsl, tps, lambda m: m.fleet.init)]
    for jmod, tmod, make in cases:
        for mod in (jmod, tmod):
            with pytest.raises(NotImplementedError):
                make(mod)
    with pytest.raises(AttributeError):
        tpb.__wrapped__            # import-machinery probes stay quiet


def test_the_rank_helpers_answer_as_the_jax_package_without_a_group():
    from paddle_tpu.distributed.helper import MPIHelper as JH
    from paddle_tpu.distributed.ps_instance import PaddlePSInstance as JI
    from paddle_tpu_torch.distributed.helper import MPIHelper as TH
    from paddle_tpu_torch.distributed.ps_instance import \
        PaddlePSInstance as TI
    j, t = JH(), TH()
    assert (t.get_rank(), t.get_size(), t.get_hostname(), t.get_ip()) == \
        (j.get_rank(), j.get_size(), j.get_hostname(), j.get_ip())
    ji, ti = JI(), TI()
    for fn in ("get_worker_index", "get_node_cnt", "is_worker", "is_server",
               "is_first_worker"):
        assert getattr(ti, fn)() == getattr(ji, fn)(), fn
    assert (ti.get_worker_index(), ti.get_node_cnt()) == (0, 1)
    ti.barrier_all()


def test_the_small_helpers_give_the_jax_packages_results(tmp_path):
    from paddle_tpu import log_helper as jl, net_drawer as jnd
    from paddle_tpu import wrapped_decorator as jw
    from paddle_tpu_torch import check_import_scipy, log_helper, net_drawer
    from paddle_tpu_torch import sysconfig, wrapped_decorator
    lg = log_helper.get_logger("ptt_test_logger", logging.INFO,
                               fmt="%(message)s")
    jlg = jl.get_logger("pt_test_logger", logging.INFO, fmt="%(message)s")
    assert (lg.level, lg.propagate, len(lg.handlers)) == \
        (jlg.level, jlg.propagate, len(jlg.handlers))
    assert log_helper.get_logger("ptt_test_logger", logging.INFO) is lg
    assert len(lg.handlers) == 1
    jm, js = _program(pt)
    tm, ts = _program(ptt)
    assert net_drawer.draw_graph(ts, tm) == jnd.draw_graph(js, jm)
    path = str(tmp_path / "g.dot")
    net_drawer.draw_graph(ts, tm, graph_path=path)
    assert open(path).read() == net_drawer.draw_graph(ts, tm)

    @wrapped_decorator.signature_safe_contextmanager
    def ctx(x):
        """doc"""
        yield x + 1

    @jw.signature_safe_contextmanager
    def jctx(x):
        """doc"""
        yield x + 1
    with ctx(1) as a, jctx(1) as b:
        assert a == b == 2
    assert (ctx.__name__, ctx.__doc__) == ("ctx", "doc")
    assert check_import_scipy.check_import_scipy(os.name) is None
    assert check_import_scipy.check_import_scipy("posix") is None
    from paddle_tpu_torch.native import build
    assert os.path.exists(os.path.join(sysconfig.get_include(),
                                       "dataplane.cc"))
    assert sysconfig.get_lib() == os.path.dirname(build.library_path())


def test_the_demo_generators_write_the_jax_packages_text():
    from paddle_tpu.incubate.data_generator import test_data_generator as j
    from paddle_tpu_torch.incubate.data_generator import \
        test_data_generator as t
    for cls in ("SyntheticData", "SyntheticStringData"):
        got, want = [], []
        getattr(t, cls)().run_from_memory(write=got.append)
        getattr(j, cls)().run_from_memory(write=want.append)
        assert got == want and len(got) > 0
    assert got[0].split()[:5] == ["4", "1", "2", "3", "4"]
