"""Tiny shapes of the configurations added after ``tiny.py``'s ``SHAPES``
(a configuration's PR adds files and leaves that table as it is): each is
put into the table before the tests run, so that every cell of
``BENCHMARK.json`` runs at a tiny shape on the CPU, never at its own."""

from benchmark.tests import tiny

NEW_SHAPES = {
    # electronics.json's two unequal modalities, a catalog larger than the
    # users and its latent graph at 8.78 interactions a user
    "electronics": {"config.data.users": 64, "config.data.items": 96,
                    "config.data.modalities": [["image", 24], ["text", 8]],
                    "config.data.graph": {"kind": "latent", "rank": 4, "train_edges": 562, "test_edges": 58,
                                          "degrees": {"min": 3, "sigma": 1.25}}},
}

for _name, _shape in NEW_SHAPES.items():
    tiny.SHAPES.setdefault(_name, _shape)
