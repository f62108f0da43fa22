"""Share of the label window's wall (``label_files``' ``wall_seconds``)
spent in the decode loops of its batches (the port's ``decode.loop``
span, its host seconds summed over the call), in percent."""


def read(rec):
    st = rec["stats"]
    loop = st.get("spans", {}).get("decode.loop")
    if not loop or not st.get("wall_seconds"):
        return None
    return 100.0 * loop["seconds"] / st["wall_seconds"]
