"""The benchmark's plain reference: Pangu-Weather's forward pass, its loss and
Adam in plain PyTorch, written from the published description. It imports
torch alone: nothing of the program under test, of JAX or of the JAX package.
"""
