# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: contextionary.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13\x63ontextionary.proto\x12\x16weaviatetpu.modules.v1\"!\n\x10VectorizeRequest\x12\r\n\x05texts\x18\x01 \x03(\t\"\x18\n\x06Vector\x12\x0e\n\x06values\x18\x01 \x03(\x02\"P\n\x0eVectorizeReply\x12/\n\x07vectors\x18\x01 \x03(\x0b\x32\x1e.weaviatetpu.modules.v1.Vector\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\r\n\x0bMetaRequest\"D\n\tMetaReply\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x12\n\nword_count\x18\x02 \x01(\x03\x12\x12\n\ndimensions\x18\x03 \x01(\x05\x32\xbb\x01\n\nVectorizer\x12]\n\tVectorize\x12(.weaviatetpu.modules.v1.VectorizeRequest\x1a&.weaviatetpu.modules.v1.VectorizeReply\x12N\n\x04Meta\x12#.weaviatetpu.modules.v1.MetaRequest\x1a!.weaviatetpu.modules.v1.MetaReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'contextionary_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTORIZEREQUEST._serialized_start=47
  _VECTORIZEREQUEST._serialized_end=80
  _VECTOR._serialized_start=82
  _VECTOR._serialized_end=106
  _VECTORIZEREPLY._serialized_start=108
  _VECTORIZEREPLY._serialized_end=188
  _METAREQUEST._serialized_start=190
  _METAREQUEST._serialized_end=203
  _METAREPLY._serialized_start=205
  _METAREPLY._serialized_end=273
  _VECTORIZER._serialized_start=276
  _VECTORIZER._serialized_end=463
# @@protoc_insertion_point(module_scope)
