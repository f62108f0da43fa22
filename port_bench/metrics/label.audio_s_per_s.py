"""Audio sent into ``label_files`` over the wall of the one call that is
the window (fill and drain included; 1/RTF), in audio-s/s, as a traced run
reads it. The step loop is bound by the host's launches, so this rate
follows the host's speed from run to run (PERF.md, sections 2 and 6): it
is reported here, beside the steady end-to-end metrics, and not held to a
bound."""


def read(rec):
    st = rec.get("stats") or {}
    if not st.get("audio_seconds") or not rec.get("window_s"):
        return None
    return st["audio_seconds"] / rec["window_s"]
