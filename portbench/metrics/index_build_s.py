"""Host clock around ``build_index``, ending in a synchronisation."""


def read(rec):
    return rec.state.index_build_s
