"""bench.py's section loop: one process, one cumulative JSON line after each
section, a failing section nulls its fields, records its error and makes
the exit non-zero, every line names the device, and no measurement is
taken without a GPU."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

DEVICE = {"platform": "gpu", "kind": "test card", "count": 1}


def run(sections):
    lines = []
    rc = bench.run_sections(sections, DEVICE, emit=lines.append)
    return rc, [json.loads(line) for line in lines]


def ok_rtfx():
    return {"value": 123.0, "vs_baseline": 0.615}


def ok_beam():
    return {"beam_rtfx": 45.0}


def broken():
    raise RuntimeError("out of memory")


def test_all_sections_pass():
    rc, lines = run([("bench_rtfx", ok_rtfx), ("bench_beam_rtfx", ok_beam)])
    assert rc == 0 and len(lines) == 2
    assert lines[-1]["value"] == 123.0 and lines[-1]["beam_rtfx"] == 45.0
    assert lines[-1]["errors"] == {}


def test_lines_are_cumulative_with_every_schema_key():
    _, lines = run([("bench_rtfx", ok_rtfx), ("bench_beam_rtfx", ok_beam)])
    keys = [k for k, _ in bench.SCHEMA] + ["device", "errors"]
    for line in lines:
        assert list(line) == keys
    assert lines[0]["beam_rtfx"] is None  # not yet run
    assert lines[1]["value"] == 123.0  # carried from the first section


@pytest.mark.parametrize("where", [0, 1, 2])
def test_failing_section_nulls_fields_and_fails_the_exit(where):
    sections = [("bench_rtfx", ok_rtfx), ("bench_beam_rtfx", ok_beam)]
    sections.insert(where, ("bench_parity", broken))
    rc, lines = run(sections)
    assert rc == 1 and len(lines) == 3  # the loop goes on past the failure
    last = lines[-1]
    assert last["parity_ok"] is None
    assert last["errors"] == {"bench_parity": "RuntimeError: out of memory"}
    assert last["value"] == 123.0 and last["beam_rtfx"] == 45.0


def test_every_line_names_the_device():
    _, lines = run([("bench_parity", broken), ("bench_rtfx", ok_rtfx)])
    assert all(line["device"] == DEVICE for line in lines)


def test_section_fields_outside_schema_are_refused():
    with pytest.raises(KeyError, match="outside SCHEMA"):
        run([("bench_rtfx", lambda: {"not_a_field": 1})])


def test_schema_covers_every_section_default():
    names = [k for k, _ in bench.SCHEMA]
    assert len(names) == len(set(names))
    assert [n for n, _ in bench.SECTIONS][0] == "bench_rtfx"
    assert all(callable(getattr(bench, n)) for n, _ in bench.SECTIONS)


def test_device_info_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.device_info()


def test_main_exits_nonzero_without_gpu(capsys):
    assert bench.main(["--no-beam"]) != 0
    assert capsys.readouterr().out == ""  # no result line


def test_cpu_children_stay_off_the_card(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    assert bench.cpu_child_env()["JAX_PLATFORMS"] == "cpu"
