"""Share of the label window's wall that ``label_files`` spent waiting on
its loader, upload and staging threads (its own ``load_wait_s``,
``upload_wait_s`` and ``stage_wait_s``), in percent."""


def read(rec):
    st = rec["stats"]
    wait = sum(st.get(k, 0.0) for k in ("load_wait_s", "upload_wait_s", "stage_wait_s"))
    return 100.0 * wait / st["wall_seconds"] if st.get("wall_seconds") else None
