from . import advection, location, operators, zipper
