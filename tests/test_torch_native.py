"""The port's C renderer (kube_scheduler_simulator_tpu_torch/native) against
the JAX package's extension and against the port's pure-Python paths
(``utils/gojson.py``, ``plugins/storereflector.py``): the annotation trail
is a byte contract, so every function must give the same bytes.  The
inputs are tests/test_native.py's.  Also pinned: the library is built into
the port's ignored build directory under its own module name, and
``KSS_NO_NATIVE=1`` or a failed build leaves a status that says why."""

from __future__ import annotations

import json
import random
import string
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from kube_scheduler_simulator_tpu import native as jax_native  # noqa: E402
from kube_scheduler_simulator_tpu_torch import native  # noqa: E402
from kube_scheduler_simulator_tpu_torch.plugins import storereflector as SR  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils import gojson  # noqa: E402

fj = native.fastjson
ref = jax_native.fastjson


def py_go_string(s: str) -> str:
    return gojson._escape_html(json.dumps(s, ensure_ascii=False))


ESCAPE_CASES = [
    "",
    "plain",
    'quo"te',
    "back\\slash",
    "html & <b> > ok",
    "ctrl\x00\x01\x1f",
    "named\b\t\n\f\r",
    "line sep   and   end",
    "\x7f",
    "\xe2 lone e-circumflex-ish",
    "caf\xe9 中文 \U0001d11e",
    "mixed \\\" & < > \n   \U0001d11e tail",
]


def test_the_renderer_loads_from_the_ignored_build_directory():
    st = native.status()
    assert st["loaded"] and fj is not None, st["reason"]
    path = Path(st["path"]).resolve()
    assert path.parent == (ROOT / "kube_scheduler_simulator_tpu_torch" / "native" / "build").resolve()
    assert path == native.library_path()
    ignored = [ln.strip().rstrip("/") for ln in (ROOT / ".gitignore").read_text().splitlines()]
    assert "kube_scheduler_simulator_tpu_torch/native/build" in ignored
    # its own module name: both packages' extensions live in one process
    assert fj.__name__ == "_kss_fastjson_torch" and ref is not None and ref.__name__ == "_kss_fastjson"
    assert "kube_scheduler_simulator_tpu" not in path.relative_to(ROOT.resolve()).parts
    # the port's bindings are the port's library
    assert gojson._fastjson is fj and SR._fastjson is fj


@pytest.mark.parametrize("s", ESCAPE_CASES, ids=range(len(ESCAPE_CASES)))
def test_escape_string_explicit_cases(s):
    want = py_go_string(s)
    assert fj.escape_string(s) == want == ref.escape_string(s)
    assert gojson._go_string_py(s) == want and gojson.go_string(s) == want
    assert '"' + fj.escape_body(s) + '"' == want


def test_escape_string_fuzz():
    rng = random.Random(42)
    pool = (
        string.ascii_letters
        + string.digits
        + '"\\&<>{}[]:,'
        + "".join(chr(c) for c in range(0x20))
        + "  \xe9中\U0001d11e\xe2"
    )
    for _ in range(5000):
        s = "".join(rng.choice(pool) for _ in range(rng.randrange(0, 60)))
        want = py_go_string(s)
        assert fj.escape_string(s) == want == ref.escape_string(s), repr(s)
        assert gojson._go_string_py(s) == want, repr(s)


def test_lone_surrogates_take_the_python_escape():
    s = "node-\ud800-x"
    with pytest.raises(UnicodeEncodeError):
        fj.escape_string(s)
    assert gojson.go_string(s) == gojson._go_string_py(s) == py_go_string(s)


@pytest.mark.parametrize("pre_escaped", [False, True])
def test_history_entry_matches_python_assembly(pre_escaped):
    keys = [gojson.go_string_key(k) for k in ["a", 'we"ird', "z&"]]
    values = ['{"j":"son"}', "plain & <value>", "ctl\n "]
    escs = [fj.escape_body(values[0]), None, fj.escape_body(values[2])] if pre_escaped else None
    want = "{" + ",".join(k + py_go_string(v) for k, v in zip(keys, values)) + "}"
    got = fj.history_entry(keys, values, escs) if pre_escaped else fj.history_entry(keys, values)
    assert got == want
    assert (ref.history_entry(keys, values, escs) if pre_escaped else ref.history_entry(keys, values)) == want
    assert json.loads(got) == {"a": values[0], 'we"ird': values[1], "z&": values[2]}


SCORE_CASES = {
    "three nodes": (['"n1":', '"n0":', '"n2":'], ['"P1":"', '"P2":"'], [["10", "20", "30", "40"], ["1", "2", "3", "4"]],
                    [3, 0, 2]),
    "empty": ([], ['"P":"'], [["1"]], []),
    "one plugin": (['"a&b":'], ['"P":"'], [["7", "8"]], [1]),
}


@pytest.mark.parametrize("case", SCORE_CASES, ids=list(SCORE_CASES))
def test_score_json_matches_python_assembly(case):
    keys, frags, rows, perm = SCORE_CASES[case]
    want = "{" + ",".join(
        k + "{" + ",".join(f + r[j] + '"' for f, r in zip(frags, rows)) + "}" for k, j in zip(keys, perm)
    ) + "}"
    assert fj.score_json(keys, frags, rows, perm) == want == ref.score_json(keys, frags, rows, perm)


def _filter_tables():
    keys = [f'"n{i}":' for i in range(6)]
    keys_esc = [fj.escape_body(k) for k in keys]
    pass_arr = [k + '{"P":"passed"}' for k in keys]
    pass_esc = [fj.escape_body(x) for x in pass_arr]
    order = np.arange(6, dtype=np.int64)  # n0..n5 are already in name order
    ftable = ['{"P":"nope & <bad>"}']
    etable = [fj.escape_body(ftable[0])]
    return keys, keys_esc, pass_arr, pass_esc, order, ftable, etable


def test_filter_json_twins():
    keys, keys_esc, pass_arr, pass_esc, order, ftable, etable = _filter_tables()
    fail_ids, fail_uidx = np.array([5], dtype=np.int64), np.array([0], dtype=np.int64)
    # window start 4, 3 processed over 6 nodes: visits 4, 5, 0; node 5 fails
    args = (pass_arr, pass_esc, keys, keys_esc, order, 4, 3, 6, fail_ids, fail_uidx, ftable, etable)
    s, esc = fj.filter_json(*args)
    assert s == "{" + pass_arr[0] + "," + pass_arr[4] + "," + keys[5] + ftable[0] + "}"
    assert '"' + esc + '"' == py_go_string(s)
    assert ref.filter_json(*args) == (s, esc)
    # every node visited, no failures
    s2, esc2 = fj.filter_json(pass_arr, pass_esc, keys, keys_esc, order, 0, 6, 6, None, None, [], [])
    assert s2 == "{" + ",".join(pass_arr) + "}" and '"' + esc2 + '"' == py_go_string(s2)
    # plain-only mode (twin arguments None): the same bytes, one str
    s3 = fj.filter_json(pass_arr, None, keys, None, order, 4, 3, 6, fail_ids, fail_uidx, ftable, None)
    assert s3 == s and isinstance(s3, str)
    assert fj.filter_json(pass_arr, None, keys, None, order, 0, 6, 6, None, None, [], None) == s2


def test_score_json_pair_twins():
    keys = ['"n1":', '"n0":']
    keys_esc = [fj.escape_body(k) for k in keys]
    frags = ['"P1":"', '"P2":"']
    frags_esc = [fj.escape_body(f) for f in frags]
    rows = [["10", "20"], ["1", "2"]]
    s, esc = fj.score_json_pair(keys, keys_esc, frags, frags_esc, rows, [1, 0])
    assert s == fj.score_json(keys, frags, rows, [1, 0])
    assert '"' + esc + '"' == py_go_string(s)
    assert ref.score_json_pair(keys, keys_esc, frags, frags_esc, rows, [1, 0]) == (s, esc)


def test_history_append2_deferred_matches_pair_twins():
    """history_append2's deferred filter and score emissions equal the pair
    functions' twins, and equal the JAX package's extension."""
    keys, keys_esc, pass_arr, pass_esc, order, ftable, etable = _filter_tables()
    fail_ids, fail_uidx = np.array([5], dtype=np.int64), np.array([0], dtype=np.int64)
    plain_f, twin_f = fj.filter_json(pass_arr, pass_esc, keys, keys_esc, order, 4, 3, 6, fail_ids, fail_uidx,
                                     ftable, etable)
    skeys = ['"n1":', '"n0":']
    skeys_esc = [fj.escape_body(k) for k in skeys]
    frags = ['"P1":"', '"P2":"']
    frags_esc = [fj.escape_body(f) for f in frags]
    rows = [["10", "20"], ["1", "2"]]
    plain_s, twin_s = fj.score_json_pair(skeys, skeys_esc, frags, frags_esc, rows, [1, 0])
    frag_keys = ['"a-filter":', '"b-score":', '"c-small":']
    args = (
        None,
        frag_keys,
        [plain_f, plain_s, 'v"x'],
        [
            ("filter", keys_esc, pass_esc, order, 4, 3, 6, fail_ids, fail_uidx, etable),
            ("score", skeys_esc, frags_esc, rows, [1, 0]),
            None,
        ],
    )
    got = fj.history_append2(*args)
    want = (
        "[{" + frag_keys[0] + '"' + twin_f + '"' + "," + frag_keys[1] + '"' + twin_s + '"'
        + "," + frag_keys[2] + fj.escape_string('v"x') + "}]"
    )
    assert got == want == ref.history_append2(*args)
    # spliced onto an existing trail, the bytes stay exact
    assert fj.history_append2(got, frag_keys[2:], ["y"], [None]) == got[:-1] + ',{"c-small":"y"}]'


ERRORS = {
    "bytes to escape": (lambda m: m.escape_string(b"bytes"), TypeError),
    "values not a list": (lambda m: m.history_entry(["k"], "notalist"), TypeError),
    "perm out of range": (lambda m: m.score_json(['"n":'], ['"P":"'], [["1"]], [5]), (IndexError, ValueError)),
    "int32 fail ids": (lambda m: m.filter_json(['"n":{}'], None, ['"n":'], None, np.arange(1, dtype=np.int64), 0, 1,
                                               1, np.zeros(1, np.int32), np.zeros(1, np.int64), ["{}"], None),
                       (TypeError, ValueError)),
}


@pytest.mark.parametrize("case", ERRORS, ids=list(ERRORS))
def test_error_paths(case):
    call, exc = ERRORS[case]
    for mod in (fj, ref):
        with pytest.raises(exc):
            call(mod)


# ---------------------------------------------- the reflector's history


def _python_path(monkeypatch):
    monkeypatch.setattr(SR, "_fastjson", None)
    monkeypatch.setattr(gojson, "_fastjson", None)


HISTORY_RESULTS = {
    "scheduler-simulator/filter-result": '{"n0":{"NodeName":"passed","TaintToleration":"node(s) had <taint> & more"}}',
    "scheduler-simulator/score-result": '{"n0":{"P":"12"}}',
    "scheduler-simulator/selected-node": "n0",
    "scheduler-simulator/bind-result": '{"DefaultBinder":"success"}',
}


@pytest.mark.parametrize("existing,trusted", [(None, False), ("[]", True), ('[{"a":"b"}]', True),
                                              ('[{"a":"b"}]', False), ("not json", False)])
def test_updated_history_matches_the_python_path(monkeypatch, existing, trusted):
    escs = {"scheduler-simulator/filter-result": fj.escape_body(HISTORY_RESULTS["scheduler-simulator/filter-result"])}
    got = SR._updated_history(existing, HISTORY_RESULTS, trusted=trusted, escs=escs)
    entry = SR._entry_json(HISTORY_RESULTS)
    with monkeypatch.context() as m:
        _python_path(m)
        want = SR._updated_history(existing, HISTORY_RESULTS, trusted=trusted, escs=escs)
        assert SR._entry_json(HISTORY_RESULTS) == entry
    assert got == want
    assert json.loads(got)[-1] == HISTORY_RESULTS


def test_updated_history_embeds_deferred_twins(monkeypatch):
    """A deferred filter spec (the batch engine's twin) embeds the same
    bytes the Python path writes by escaping the plain document."""
    keys, keys_esc, pass_arr, pass_esc, order, ftable, etable = _filter_tables()
    fail_ids, fail_uidx = np.array([5], dtype=np.int64), np.array([0], dtype=np.int64)
    doc = fj.filter_json(pass_arr, None, keys, None, order, 4, 3, 6, fail_ids, fail_uidx, ftable, None)
    spec = ("filter", keys_esc, pass_esc, order, 4, 3, 6, fail_ids, fail_uidx, etable)
    results = dict(HISTORY_RESULTS, **{"scheduler-simulator/filter-result": doc})
    escs = {"scheduler-simulator/filter-result": spec}
    got = SR._updated_history("[]", results, trusted=True, escs=escs)
    with monkeypatch.context() as m:
        _python_path(m)
        assert SR._updated_history("[]", results, trusted=True, escs=escs) == got
    assert json.loads(got) == [results]


def test_lone_surrogates_in_history_take_the_python_path(monkeypatch):
    results = dict(HISTORY_RESULTS, **{"scheduler-simulator/selected-node": "node-\udc80"})
    got = SR._updated_history(None, results)
    with monkeypatch.context() as m:
        _python_path(m)
        assert SR._updated_history(None, results) == got


# ------------------------------------------------------------ the loader


def test_no_native_gives_a_status_that_says_why():
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "from kube_scheduler_simulator_tpu_torch import native;"
        "from kube_scheduler_simulator_tpu_torch.utils import gojson;"
        "print(json.dumps([native.status(), native.fastjson is None, gojson._fastjson is None,"
        " gojson.go_string('a\"<b>')]))"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "KSS_NO_NATIVE": "1"})
    assert proc.returncode == 0, proc.stderr
    st, none, gnone, quoted = json.loads(proc.stdout.strip().splitlines()[-1])
    assert none and gnone and not st["loaded"] and st["path"] is None
    assert "KSS_NO_NATIVE" in st["reason"]
    assert quoted == py_go_string('a"<b>')


@pytest.mark.parametrize("cc,why", [("kss-no-such-compiler", "no compiler"), ("false", "exited 1")])
def test_a_failed_build_says_why(tmp_path, cc, why):
    reason = native._build(cc, tmp_path / "lib.so")
    assert reason is not None and why in reason
    assert not list(tmp_path.iterdir())  # no temporary file left behind
