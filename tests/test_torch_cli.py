"""The port's command line, REPL and file formats on the CPU, against the JAX
package's.

Tolerances: the CLI's float audio against grail_tpu.cli's on the CPU (there
the XLA block core, here the fused plain version: the same f32 algorithm in
another operation grouping) at sample_error_db < -100; the 16-bit WAVs then
have equal headers and PCM values within one step. Printed lines are equal
but the timing. File formats are bit for bit.
"""

import io
import json
import re

import numpy as np
import pytest
import torch

from grail_tpu import cli as jcli
from grail_tpu.languages import fileformat as jlf
from grail_tpu.languages import get_language as jget_language
from grail_tpu.voices import fileformat as jvf
from grail_tpu.voices import get_voice as jget_voice

import grail_tpu_torch as g
from grail_tpu_torch import cli as pcli
from grail_tpu_torch import interactive as prepl
from grail_tpu_torch.languages import fileformat as plf
from grail_tpu_torch.runtime.wav import load_wav
from grail_tpu_torch.utils import sample_error_db
from grail_tpu_torch.voices import fileformat as pvf
from grail_tpu_torch.voices import get_spec

torch.set_num_threads(2)


def _run(mod, argv, capsys, monkeypatch):
    """main(argv) of one CLI module: (exit code, printed lines with the
    timing taken out, the float audio handed to save_wav)."""
    audio = []
    real = mod.save_wav

    def spy(path, data, sr):
        audio.append(np.asarray(data, np.float32))
        real(path, data, sr)

    monkeypatch.setattr(mod, "save_wav", spy)
    rc = mod.main(argv)
    out = capsys.readouterr().out
    out = re.sub(r"generated in \d+ microseconds", "generated in N", out)
    return rc, out.splitlines(), (audio[0] if audio else None)


def test_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    jw, pw = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    args = ["-s", "-v", "plain", "-l", "english"]
    jrc, jout, ja = _run(jcli, args + ["-o", jw, "hi"], capsys, monkeypatch)
    prc, pout, pa = _run(pcli, args + ["--device", "cpu", "-o", pw, "hi"],
                         capsys, monkeypatch)
    assert jrc == prc == 0
    assert pout == [ln.replace(jw, pw) for ln in jout]
    assert pout[0] == '"hi"' and pout[1] == " -- plain"
    assert pa.shape == ja.shape and sample_error_db(pa, ja) < -100
    jb, pb = open(jw, "rb").read(), open(pw, "rb").read()
    assert jb[:44] == pb[:44] and len(jb) == len(pb)
    jp, pp = (np.frombuffer(b[44:], np.int16).astype(np.int32)
              for b in (jb, pb))
    assert np.abs(jp - pp).max() <= 1
    data, sr = load_wav(pw)
    assert sr == 44100 and len(data) == len(pa) and np.isfinite(data).all()
    assert np.abs(data).max() > 0.05


def test_cli_probes(tmp_path, capsys):
    main = pcli.main
    assert main(["--device", "cpu", "-v", "nosuch", "ae"]) == 1
    assert "error: unknown voice 'nosuch'" in capsys.readouterr().out
    assert main(["--device", "cpu", "-l", "nosuch", "ae"]) == 1
    assert "error: unknown language" in capsys.readouterr().out
    assert main(["--device", "cpu", "-i", "/nonexistent", "x"]) == 1
    assert "Could not open file" in capsys.readouterr().out
    assert main(["--device", "tpu", "ae"]) == 1
    assert "--device expects" in capsys.readouterr().out
    assert main(["--device", "cpu", "-r", "-5", "ae"]) == 1
    assert main(["-h"]) == 0
    helped = capsys.readouterr().out
    assert "--device" in helped and "  plain" in helped
    assert main(["-V"]) == 0
    assert g.__version__ in capsys.readouterr().out
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["-s", "ae"])


def test_cli_resample_and_input_file(tmp_path, capsys):
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    txt = tmp_path / "in.txt"
    txt.write_text("a")
    assert pcli.main(["--device", "cpu", "-s", "-o", a, "a"]) == 0
    assert pcli.main(["--device", "cpu", "-s", "-r", "22050", "-i", str(txt),
                      "-o", b, "ignored"]) == 0
    (da, ra), (db, rb) = load_wav(a), load_wav(b)
    assert (ra, rb) == (44100, 22050)
    assert abs(len(da) / ra - len(db) / rb) < 0.01      # the same duration
    assert np.isfinite(db).all() and np.abs(db).max() > 0.05


def test_cli_json_voice_and_language(tmp_path, capsys):
    vpath, lpath = str(tmp_path / "v.json"), str(tmp_path / "l.json")
    pvf.save_voice_file(vpath, get_spec("generic"))
    plf.save_language_file(lpath, g.get_language("generic"))
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    assert pcli.main(["--device", "cpu", "-s", "-v", vpath, "-l", lpath,
                      "-o", a, "a"]) == 0
    assert pcli.main(["--device", "cpu", "-s", "-o", b, "a"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert pcli.main(["--device", "cpu", "-s", "-v", str(bad), "ae"]) == 1
    bad.write_text("not json")
    assert pcli.main(["--device", "cpu", "-s", "-l", str(bad), "ae"]) == 1


@pytest.mark.parametrize("name", ["generic", "plain"])
def test_voice_file_round_trip_against_jax_loader(tmp_path, name):
    path = str(tmp_path / "v.json")
    pvf.save_voice_file(path, get_spec(name))
    pv, jv, ref = pvf.load_voice_file(path), jvf.load_voice_file(path), \
        jget_voice(name)
    for f in pv.table._fields:
        np.testing.assert_array_equal(np.asarray(getattr(pv.table, f)),
                                      np.asarray(getattr(ref.table, f)))
        np.testing.assert_array_equal(np.asarray(getattr(jv.table, f)),
                                      np.asarray(getattr(ref.table, f)))
    np.testing.assert_array_equal(np.asarray(pv.defined),
                                  np.asarray(ref.defined))
    assert (pv.name, pv.sample_rate, pv.center_frequency,
            pv.jitter_frequency) == (ref.name, ref.sample_rate,
                                     ref.center_frequency,
                                     ref.jitter_frequency)
    # the documents the two packages write are the same
    doc = pvf.spec_to_dict(get_spec(name))
    jpath = str(tmp_path / "jv.json")
    jvf.save_voice_file(jpath, jvf.spec_from_dict(json.loads(
        json.dumps(doc))))
    assert json.load(open(jpath)) == json.load(open(path)) == doc


@pytest.mark.parametrize("name", ["english", "deutsch"])
def test_language_file_round_trip_against_jax_loader(tmp_path, name):
    path = str(tmp_path / "l.json")
    plf.save_language_file(path, g.get_language(name))
    pl, jl, ref = plf.load_language_file(path), jlf.load_language_file(path), \
        jget_language(name)
    assert [(r.string, tuple(int(p) for p in r.phonemes))
            for r in pl.rules] == \
        [(r.string, tuple(int(p) for p in r.phonemes)) for r in ref.rules]
    assert jl.rules == ref.rules
    assert pl.case_sensitive == ref.case_sensitive
    assert vars(pl.intonation) == vars(ref.intonation)
    assert plf.language_to_dict(pl) == jlf.language_to_dict(ref)


def test_repl_one_line_on_the_cpu(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "live.wav")
    monkeypatch.setattr("sys.stdin", io.StringIO("[rate:4] a\n"))
    assert prepl.main(["--device", "cpu", "-o", out, "-v", "plain",
                       "-l", "english", "--block", "1024"]) == 0
    err = capsys.readouterr().err
    assert "wrote" in err and out in err
    data, sr = load_wav(out)
    assert sr == 44100 and len(data) > 4000
    assert np.isfinite(data).all() and np.abs(data).max() > 0.05
    # a bad voice is a clean error, not a traceback
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert prepl.main(["--device", "cpu", "-v", "nosuch"]) == 1
    assert "error:" in capsys.readouterr().err


def test_entry_points_import_no_jax():
    import os
    import subprocess
    import sys

    code = ("import sys, grail_tpu_torch.cli, grail_tpu_torch.interactive, "
            "grail_tpu_torch.__init__, grail_tpu_torch.oracle, "
            "grail_tpu_torch.runtime.native, grail_tpu_torch.runtime.wav, "
            "grail_tpu_torch.runtime.playback, "
            "grail_tpu_torch.benchmarks.fma_peak, "
            "grail_tpu_torch.benchmarks.kernel1_ab, "
            "grail_tpu_torch.voices.fileformat, "
            "grail_tpu_torch.languages.fileformat; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'grail_tpu')); assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_playback_sink_matches_jax_package():
    # the paced mock sink (no audio device here): the same pull contract
    # and counters as grail_tpu's, the audio handed back bit for bit
    from grail_tpu.runtime import playback as jpb
    from grail_tpu_torch.runtime import playback as ppb

    x = np.linspace(-0.5, 0.5, 4096).astype(np.float32)
    stats = []
    for mod in (jpb, ppb):
        sink = mod.CallbackSink(44100, block=1024, mode="manual")
        sink.write(x)
        sink.end()
        got = np.concatenate([sink.pull() for _ in range(5)])
        np.testing.assert_array_equal(got[:4096], x)
        assert not got[4096:].any()
        stats.append(sink.close())
    assert stats[0].keys() == stats[1].keys()
    assert (stats[0]["pulls"], stats[0]["underruns"]) == \
        (stats[1]["pulls"], stats[1]["underruns"])
