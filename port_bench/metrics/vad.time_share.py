"""Share of the label window's wall spent in the VAD (``label_files``'s
``vad_s``), in percent."""


def read(rec):
    st = rec["stats"]
    return 100.0 * st["vad_s"] / st["wall_seconds"] if st.get("wall_seconds") else None
