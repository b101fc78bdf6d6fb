"""The merged store's resident bytes (``ParamStore.resident_bytes()`` after
every trunk group is merged), in GiB."""


def read(run):
    return run.resident_bytes / 2 ** 30 if run.resident_bytes else None
