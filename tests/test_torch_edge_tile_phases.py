"""The phase marks of ``probes/edge_tile_phases.py`` still fit the kernels.

The probe times the bf16 EGCL tile phase by phase on the card by editing a
copy of the sources; here, on the CPU, every edit must apply exactly once
to the sources as they stand, so the probe cannot silently time the wrong
code.
"""

import pytest

from diffusion_model_tpu_torch.probes import edge_tile_phases as etp


def test_every_mark_applies_once(tmp_path):
    paths = etp.instrumented_sources(tmp_path)
    assert [p.name for p in paths] == list(etp.SOURCES)
    header = (tmp_path / etp.HEADER).read_text()
    assert (tmp_path / etp.SHARED).is_file()     # the header it includes
    for i in range(len(etp.PHASES)):
        assert f"egcl_phase_cycles[{i}]" in header
    for p in paths:
        assert "egcl_phase_cycles_read" in p.read_text()


@pytest.mark.parametrize("k", range(len(etp.EDITS)))
def test_a_moved_anchor_is_refused(tmp_path, monkeypatch, k):
    edits = list(etp.EDITS)
    old, new = edits[k]
    edits[k] = (old + "\n// not in the source", new)
    monkeypatch.setattr(etp, "EDITS", tuple(edits))
    with pytest.raises(RuntimeError, match="does not apply once"):
        etp.instrumented_sources(tmp_path)


def test_main_needs_the_card(monkeypatch, capsys):
    monkeypatch.setattr(etp, "card_or_none", lambda: None)
    assert etp.main([]) == 1
