"""How the port refuses what it has not ported yet."""


def refuse(what: str, item: str) -> None:
    """Raise NotImplementedError naming the ROADMAP item that ports ``what``."""
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")
