from . import render
