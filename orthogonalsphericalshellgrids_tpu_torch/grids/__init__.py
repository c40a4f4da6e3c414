from . import geometry, immersed, latlon, tripolar
