"""tools/torch_build_lexicon.py on a tiny synthetic reference tree: the
blob's five tables, the first-occurrence rule of trad2simp, and the blob
read back by the port's lexicon loader. Writes only under tmp_path."""

import gzip
import importlib.util
import json
from pathlib import Path

import pytest

from music_generation_tpu_torch.frontend import lexicon

TOOL = Path(__file__).resolve().parents[1] / "tools" / "torch_build_lexicon.py"


def _tool():
    spec = importlib.util.spec_from_file_location("torch_build_lexicon", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference(root: Path, simple: str = "丢并丢干") -> None:
    data = root / "text_normalizers" / "data"
    data.mkdir(parents=True)
    (root / "VISinger").mkdir()
    files = {data / "monosyllable.csv": {"我": "wo3", "丢": "diu1"},
             data / "polyphone.csv": {"长": {"chang2": ["长度"],
                                            "zhang3": ["长大"]}},
             root / "VISinger" / "phone_set.json": ["AP", "SP", "a"],
             root / "VISinger" / "phone_shengdiao_set.json": ["AP", "a1"]}
    for path, value in files.items():
        path.write_text(json.dumps(value, ensure_ascii=False),
                        encoding="utf-8")
    (root / "text_normalizers" / "phoneme_generator.py").write_text(
        'import re\n\nTRADITION = r"丟並丟乾"\nSIMPLE = r"' + simple +
        '"\n\n\ndef g2p(text):\n    return text\n', encoding="utf-8")


def test_builds_the_blob_the_port_loads(tmp_path):
    _reference(tmp_path / "ref", simple="丢并X干")
    out = tmp_path / "out" / "lexicon.json.gz"
    assert _tool().main(["--ref", str(tmp_path / "ref"),
                         "--out", str(out)]) == 0
    with gzip.open(out, "rt", encoding="utf-8") as f:
        blob = json.load(f)
    assert sorted(blob) == ["monosyllable", "phone_set",
                            "phone_shengdiao_set", "polyphone", "trad2simp"]
    # the first occurrence of 丟 wins over the later 丟 -> X
    assert blob["trad2simp"] == {"丟": "丢", "並": "并", "乾": "干"}
    assert blob["monosyllable"]["我"] == "wo3"
    lex = lexicon.load_lexicon.__wrapped__(str(out))
    assert lex.to_simplified("丟乾我") == "丢干我"
    assert lex.phone_set == ("AP", "SP", "a")


def test_refuses_tables_of_unequal_length(tmp_path):
    _reference(tmp_path, simple="丢并")
    with pytest.raises(ValueError, match="TRADITION has 4"):
        _tool().build_lexicon(str(tmp_path))


def test_needs_a_reference(monkeypatch):
    monkeypatch.delenv("MUSIC_GEN_REFERENCE_DIR", raising=False)
    with pytest.raises(SystemExit):
        _tool().main([])
