"""ASCII PLY mesh reader (reference: ``MeshPly.py:3-49``).

The port's own copy of ``singleshotpose_tpu/utils/meshply.py`` (plain
Python), so the port imports nothing of the JAX package;
``tests/test_torch_host.py`` holds it equal to the original.  Same data
surface as the reference class — ``vertices`` / ``normals`` / ``colors`` /
face ``indices`` as Python lists.  Parsing is header-driven: ``element
vertex N`` / ``element face M`` counts then body rows, colors normalized by
255 with a configurable default.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["MeshPly"]


class MeshPly:
    def __init__(self, filename: str, color: Sequence[float] = (0.0, 0.0, 0.0)):
        self.vertices: List[List[float]] = []
        self.colors: List[List[float]] = []
        self.indices: List[List[float]] = []
        self.normals: List[List[float]] = []

        nb_vertices = 0
        nb_faces = 0
        vertex_mode = False
        face_mode = False
        idx = 0

        with open(filename, "r") as f:
            for line in f:
                elements = line.split()
                if not elements:
                    continue
                if vertex_mode:
                    self.vertices.append([float(i) for i in elements[:3]])
                    self.normals.append([float(i) for i in elements[3:6]])
                    if elements[6:9]:
                        self.colors.append([float(i) / 255.0 for i in elements[6:9]])
                    else:
                        self.colors.append([float(i) / 255.0 for i in color])
                    idx += 1
                    if idx == nb_vertices:
                        vertex_mode = False
                        face_mode = True
                        idx = 0
                elif face_mode:
                    self.indices.append([float(i) for i in elements[1:4]])
                    idx += 1
                    if idx == nb_faces:
                        face_mode = False
                elif elements[0] == "element":
                    if elements[1] == "vertex":
                        nb_vertices = int(elements[2])
                    elif elements[1] == "face":
                        nb_faces = int(elements[2])
                elif elements[0] == "end_header":
                    vertex_mode = True
