from .timelapse import Timelapse, TimelapseParser
