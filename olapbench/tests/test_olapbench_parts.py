"""A cell's parts are found by name and taken as they are written: every
key of a mix's ``engine`` and ``compile`` reaches the program, an unknown
one is refused, and a metric split by cells shares one reader."""
import pytest

from olapbench import harness


def test_every_engine_key_reaches_the_engine_config():
    _, config, mix, _ = harness.cell_parts("tpch-sf10-narrow-p01.join")
    mix = dict(mix, engine=dict(mix["engine"], storage_tier="process",
                                executor="reference", residual="tensor",
                                measured_feedback=False))
    cfg = harness.engine_config(config, mix, "cpu")
    assert (cfg.mode, cfg.residual, cfg.storage_tier, cfg.executor,
            cfg.measured_feedback) == ("adaptive", "tensor", "process",
                                       "reference", False)
    assert cfg.res.storage_power == 0.1 and cfg.device == "cpu"


@pytest.mark.parametrize("key", ["resdiual", "res", "device"])
def test_an_unknown_engine_key_is_refused(key):
    _, config, mix, _ = harness.cell_parts("tpch-sf10-wide-p1.join")
    mix = dict(mix, engine=dict(mix["engine"], **{key: 1}))
    with pytest.raises(ValueError, match=key):
        harness.engine_config(config, mix, "cpu")


def test_compile_keys_reach_compile_and_run():
    _, _, mix, _ = harness.cell_parts("tpch-sf10-wide-p1.scan")
    assert harness.compile_options(mix) == {}
    mix = dict(mix, compile={"cost_based": True, "fact_selectivity": 0.5})
    assert harness.compile_options(mix) == {"cost_based": True,
                                            "fact_selectivity": 0.5}
    with pytest.raises(ValueError, match="cost_basd"):
        harness.compile_options(dict(mix, compile={"cost_basd": True}))


def test_the_cells_metrics_each_find_a_reader():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]
    assert harness.reader("pushdown_roofline.join").__module__ == \
        harness.reader("pushdown_roofline.scan").__module__
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.join")
