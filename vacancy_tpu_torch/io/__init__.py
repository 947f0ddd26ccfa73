from .meshio import load_ply, write_ply
