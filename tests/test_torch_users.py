"""The port's user and experiment-sharing registry against the JAX
package's: the same operations write the same ``users.json`` bytes and
grant the same permissions, and each package reads the other's file."""

import numpy as np
import pytest

from tmlibrary_tpu.models import user as j_user
from tmlibrary_tpu_torch.models import user

OPS = [
    ("add", "ada", "ada@lab.org"), ("add", "bob", ""), ("add", "cy", "cy@lab.org"),
    ("owner", "plate1", "ada"), ("owner", "plate2", "bob"),
    ("share", "plate1", "bob", False), ("share", "plate1", "cy", True),
    ("share", "plate2", "ada", True), ("owner", "plate1", "cy"),
]


def apply(mod, path, ops):
    reg = mod.UserRegistry(path)
    for op in ops:
        if op[0] == "add":
            reg.add_user(mod.User(op[1], op[2]))
        elif op[0] == "owner":
            reg.set_owner(op[1], op[2])
        else:
            reg.share(mod.ExperimentShare(op[1], op[2], write=op[3]))
    return reg


@pytest.mark.parametrize("n_ops", [3, 5, len(OPS)])
def test_the_same_operations_write_the_same_file(tmp_path, n_ops):
    ref = apply(j_user, tmp_path / "ref" / "users.json", OPS[:n_ops])
    port = apply(user, tmp_path / "port" / "users.json", OPS[:n_ops])
    assert (tmp_path / "port" / "users.json").read_bytes() == \
        (tmp_path / "ref" / "users.json").read_bytes()
    assert [(u.name, u.email) for u in port.users()] == [(u.name, u.email) for u in ref.users()]
    grid = np.random.default_rng(0).permutation(
        [(e, u) for e in ("plate1", "plate2", "plate3") for u in ("ada", "bob", "cy", "dan")])
    for exp, name in grid:
        assert port.can_read(exp, name) == ref.can_read(exp, name)
        assert port.can_write(exp, name) == ref.can_write(exp, name)


def test_each_reads_the_others_file_and_refuses_unknown_users(tmp_path):
    apply(j_user, tmp_path / "users.json", OPS)
    port = user.UserRegistry(tmp_path / "users.json")
    assert port.can_write("plate1", "cy") and not port.can_write("plate1", "bob")
    assert port.can_read("plate1", "bob") and not port.can_read("plate2", "cy")
    port.add_user(user.User("dan"))
    ref = j_user.UserRegistry(tmp_path / "users.json")
    assert [u.name for u in ref.users()] == ["ada", "bob", "cy", "dan"]
    for mod in (user, j_user):
        reg = mod.UserRegistry(tmp_path / f"{mod.__name__}.json")
        with pytest.raises(KeyError):
            reg.set_owner("plate1", "nobody")
        with pytest.raises(KeyError):
            reg.share(mod.ExperimentShare("plate1", "nobody"))


def test_the_version_is_the_references():
    import tmlibrary_tpu.version as j_version

    import tmlibrary_tpu_torch

    assert tmlibrary_tpu_torch.__version__ == j_version.__version__
